"""Decoder-only LM (Llama-style): GQA + RoPE + RMSNorm + SwiGLU.

Counterpart of ``arkflow_tpu/models/decoder.py`` on one device: ``init``,
``_rope``, ``_mlp`` (dense SwiGLU, or the Switch MoE ``_moe_mlp`` with
``num_experts > 1``), ``_attention_block``, ``forward`` /
``apply``, ``select_token`` (greedy, or temperature / top-k sampling) and
the contiguous KV cache of batched generation (``init_kv_cache``,
``prefill``, ``decode_step``, ``generate``), and ``from_hf_state_dict``
(a HuggingFace Llama state dict as a float32 tree). Params keep the JAX tree's
layout -- the same nested paths, dense ``w`` stored ``[in, out]``,
per-layer params stacked on a leading axis -- and the layer scan is a
Python loop over that axis. Defaults are a small test shape;
``llama3_8b()`` gives the production shape. The incremental paths over the
paged KV cache are in ``models/paged_decode.py``; the CUDA-graph form of
``generate`` is ``tpu/batch_generate.py``.

Sampling keys. JAX threads a ``jax.random`` key through every sampled
step; its stream cannot be reproduced here, so the port has keys of its
own with the same roles: ``make_key(seed)`` (``PRNGKey``) and
``split_key(key) -> (key, subkey)`` (``split``) are 64-bit integers mixed
on the host (splitmix64), and a step draws from its subkey's two 32-bit
words (``key_words``), passed to the device as an int64 tensor. The draw
is Gumbel-max, as ``jax.random.categorical`` is: a counter-based hash of
(key, row, vocabulary index) in int64 tensor ops (every product below
2^63, so the integer stage is the same on the CPU and the card), 23 bits
of it as a uniform strictly inside (0, 1), and ``argmax(logits / T +
gumbel)``. Nothing reads a global generator, so a CUDA graph that takes
the subkey as an input draws new numbers at every replay and the same
numbers as the eager step.

The contiguous cache is written in place (the JAX functions return a new
cache that XLA updates in place): ``prefill`` and ``decode_step`` return
the cache they were given, its K/V, cursor and lengths updated. The write
cursor and the lengths stay device tensors, so one captured decode step
serves every step of a generation.

MoE (``num_experts > 1``) is JAX's Switch layer: top-1 routing, a
per-expert capacity fixed by the call's shapes, overflow and masked tokens
dropped to a zero output (``_moe_mlp``). It runs in every path: ``forward``
unmasked, ``prefill`` masked by the prompt lengths, ``decode_step``
unmasked (as JAX's: padding and finished rows of a batch take expert
capacity), and the paged paths masked by their valid positions.

Where the port departs from the JAX code without changing the function:
``prefill`` runs the final norm and the LM head on each row's last true
position only (both are row-wise), as ``models/paged_decode.py`` does;
``_moe_mlp`` scatters each kept token into its (expert, slot) row and
gathers it back instead of building JAX's one-hot ``[T, E, C]`` dispatch
tensor, which gives the same numbers (each dispatch and combine sum there
has one non-zero term).

Not ported yet (each raises "not yet ported"): ring attention and
``remat`` (a training knob). ``loss_fn``, ``make_train_step``,
``param_specs`` and ``pp_stage_fns`` wait for the training and
multi-device slices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from arkflow_tpu_torch.errors import ConfigError, not_ported
from arkflow_tpu_torch.models import common as cm
from arkflow_tpu_torch.models.common import layer_params
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
    float32 and cast, one layer (one expert) at a time, so the float32 draw
    of the whole tree (32 GB at Llama-3-8B) never exists.

    With ``num_experts > 1`` (JAX's MoE branch) a layer has no dense MLP
    but ``router`` (a bias-free dense ``[dim, E]``, kept in float32: the
    router's logits are float32) and ``experts.{w_gate, w_up, w_down}``
    (``[E, dim, ffn]``, ``[E, dim, ffn]``, ``[E, ffn, dim]``, uniform in
    +-1/sqrt(dim), in ``dtype``)."""
    device = torch.device(device) if device is not None else gen.device
    dh = cfg.dim // cfg.heads
    e = cfg.num_experts
    moe = e > 1

    def uniform(shape: tuple, scale: float) -> torch.Tensor:
        return torch.empty(*shape, device=device).uniform_(-scale, scale, generator=gen)

    def dense(in_dim: int, out_dim: int) -> dict:
        return {"w": uniform((in_dim, out_dim), 1.0 / math.sqrt(in_dim)).to(dtype)}

    table = torch.randn(cfg.vocab_size, cfg.dim, device=device, generator=gen) * 0.02
    params = {
        "embed": {"table": table.to(dtype)},
        "norm_out": cm.rms_norm_init(cfg.dim, device),
        "lm_head": dense(cfg.dim, cfg.vocab_size),
    }
    del table
    mlp = {"w_gate": (cfg.dim, cfg.ffn), "w_up": (cfg.dim, cfg.ffn),
           "w_down": (cfg.ffn, cfg.dim)}
    shapes = {"wq": (cfg.dim, cfg.heads * dh), "wk": (cfg.dim, cfg.kv_heads * dh),
              "wv": (cfg.dim, cfg.kv_heads * dh), "wo": (cfg.heads * dh, cfg.dim),
              **({} if moe else mlp)}
    layers = {name: {"w": torch.empty(cfg.layers, *shape, device=device, dtype=dtype)}
              for name, shape in shapes.items()}
    if moe:
        layers["router"] = {"w": torch.empty(cfg.layers, cfg.dim, e, device=device)}
        layers["experts"] = {name: torch.empty(cfg.layers, e, *shape, device=device, dtype=dtype)
                             for name, shape in mlp.items()}
    scale = 1.0 / math.sqrt(cfg.dim)
    for i in range(cfg.layers):
        for name, (in_dim, out_dim) in shapes.items():
            layers[name]["w"][i] = dense(in_dim, out_dim)["w"]
        if moe:
            layers["router"]["w"][i] = uniform((cfg.dim, e), scale)
            for name, shape in mlp.items():
                for j in range(e):
                    layers["experts"][name][i, j] = uniform(shape, scale).to(dtype)
    layers["attn_norm"] = {"scale": torch.ones(cfg.layers, cfg.dim, device=device)}
    layers["mlp_norm"] = {"scale": torch.ones(cfg.layers, cfg.dim, device=device)}
    params["layers"] = layers
    return params


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


def expert_capacity(cfg: DecoderConfig, tokens: int) -> int:
    """Slots per expert for a call over ``tokens`` tokens, as JAX computes
    it: ``max(1, ceil(tokens / E * capacity_factor))``, a Python int."""
    return max(1, math.ceil(tokens / cfg.num_experts * cfg.capacity_factor))


def route(lp: dict, yf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router of one MoE layer over [T, D] tokens: float32 logits
    [T, E], their softmax, and the top expert of each token (the first of a
    tie)."""
    logits = cm.dense(lp["router"], yf, dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)
    return logits, probs, torch.argmax(probs, dim=-1)


def switch_experts(ex: dict, yf: torch.Tensor, top: torch.Tensor, weight: torch.Tensor,
                   capacity: int, token_mask: Optional[torch.Tensor] = None):
    """Dispatch, the experts' SwiGLU and the weighted combine of a Switch
    layer, given each token's expert ``top`` [T] and ``weight`` [T]:
    (out [T, D] float32, routed [T, E] int64 one-hot of the tokens that
    took a queue position).

    Tokens queue into their expert in index order; a masked token
    (``token_mask`` [T] false) takes no position, and a token past
    ``capacity`` or masked gets a zero output. Each kept token is copied
    into row (expert, slot) of an [E*C + 1, D] buffer (row E*C takes every
    other token and is never read), the experts run as three ``bmm`` over
    [E, C, .] in yf's dtype (silu in float32, then cast), and each kept
    token reads its row back times its weight, in float32. JAX's one-hot
    dispatch and combine einsums have one non-zero term per sum, so this
    gives their numbers. Nothing reads the device from the host and no
    shape depends on the routing, so a CUDA graph can capture it."""
    e = ex["w_gate"].shape[0]
    dtype = yf.dtype
    onehot = top[:, None] == torch.arange(e, device=yf.device)  # [T, E]
    if token_mask is not None:
        onehot = onehot & token_mask.reshape(-1, 1).to(torch.bool)
    routed = onehot.to(torch.int64)
    # position in the expert's queue: the running count of its routed tokens
    pos = (routed.cumsum(0) * routed).sum(-1) - 1  # [T]; -1 = not routed
    keep = (pos >= 0) & (pos < capacity)
    rows = torch.where(keep, top * capacity + pos, e * capacity)  # [T]
    buf = yf.new_zeros(e * capacity + 1, yf.shape[1])
    buf.index_copy_(0, rows, yf)
    expert_in = buf[:e * capacity].view(e, capacity, yf.shape[1])
    gate = torch.bmm(expert_in, ex["w_gate"].to(dtype))
    up = torch.bmm(expert_in, ex["w_up"].to(dtype))
    act = torch.nn.functional.silu(gate.float()).to(dtype) * up
    expert_out = torch.bmm(act, ex["w_down"].to(dtype)).reshape(e * capacity, -1)
    picked = expert_out.index_select(0, torch.where(keep, rows, 0)).float()
    return torch.where(keep[:, None], picked * weight[:, None], 0.0), routed


class RoutingTrace:
    """MoE routing held across two runs of the same calls, such as the
    parity gate's two attention paths: while ``recording``, each MoE call
    keeps its top experts here; once ``replay()`` is called, each call
    takes them back in call order in place of its own argmax, and the
    routed decisions where its own choice differs are counted (``flips``).

    Top-1 routing is discontinuous: two attention paths that round apart
    move a router logit by ~1e-3, which flips a near-tied choice, and a
    flipped expert moves that token's logits far more than rounding does.
    With the routing held, two paths are compared on what they compute."""

    def __init__(self):
        self.replaying = False
        self.tops: list[torch.Tensor] = []
        self.at = 0
        self._flips: list[torch.Tensor] = []
        self._replayed: list[torch.Tensor] = []

    def replay(self) -> "RoutingTrace":
        self.replaying, self.at = True, 0
        return self

    def take(self, top: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        if not self.replaying:
            self.tops.append(top)
            return top
        if self.at >= len(self.tops) or self.tops[self.at].shape != top.shape:
            raise RuntimeError("routing replay: the calls differ from the recorded run's")
        held = self.tops[self.at]
        self.at += 1
        self._flips.append(((held != top) & live).sum())
        self._replayed.append(live.sum())
        return held

    def flips(self) -> int:
        """Replayed decisions whose own argmax differed (reads the device)."""
        return int(sum(int(f) for f in self._flips))

    def replayed(self) -> int:
        """Routed (unmasked) decisions replayed (reads the device)."""
        return int(sum(int(n) for n in self._replayed))


#: the routing trace MoE calls on this thread record into or replay from
_routing = threading.local()


@contextlib.contextmanager
def holding_routing(trace: Optional[RoutingTrace]):
    """MoE calls on this thread record into (or replay from) ``trace``."""
    prev = getattr(_routing, "trace", None)
    _routing.trace = trace
    try:
        yield trace
    finally:
        _routing.trace = prev


def _moe_mlp(lp: dict, y: torch.Tensor, cfg: DecoderConfig,
             token_mask: Optional[torch.Tensor] = None):
    """Switch-style top-1 MoE SwiGLU with a per-expert capacity, as JAX's
    ``_moe_mlp``: y [B, S, D] -> (out [B, S, D] in y's dtype, (lb, z)).

    Router logits in float32; softmax, then the top expert (the first of a
    tie) with its probability as the token's weight (``route``). Tokens
    queue into their expert in b-major order over the flattened [B*S]
    tokens; the capacity is fixed by the call's shapes
    (``expert_capacity``), and a token past it gets a zero output.
    ``token_mask`` ([B, S] bool) takes tokens out of routing: they hold no
    queue position and get a zero output (``switch_experts``). Under
    ``holding_routing`` the top experts are recorded or replayed.

    ``(lb, z)``: the Switch aux stats, ``E * sum(frac * mean_prob)`` (frac
    counts the routed, unmasked tokens over all B*S) and the mean squared
    logsumexp of the router logits."""
    b, s, d = y.shape
    e = lp["experts"]["w_gate"].shape[0]
    yf = y.reshape(b * s, d)
    logits, probs, top = route(lp, yf)
    trace = getattr(_routing, "trace", None)
    if trace is not None:
        live = (torch.ones_like(top, dtype=torch.bool) if token_mask is None
                else token_mask.reshape(-1).to(torch.bool))
        top = trace.take(top, live)
    weight = probs.gather(1, top[:, None])[:, 0]
    out, routed = switch_experts(lp["experts"], yf, top, weight,
                                 expert_capacity(cfg, b * s), token_mask)
    lb = e * (routed.float().mean(0) * probs.mean(0)).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return out.reshape(b, s, d).to(y.dtype), (lb, z)


def _mlp(lp: dict, y: torch.Tensor, cfg: DecoderConfig,
         token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense SwiGLU, or the Switch MoE (aux stats dropped) with
    ``num_experts > 1``: the shared MLP of the incremental-decode paths.
    ``token_mask`` ([B, S]) reaches the MoE only; the dense MLP is
    row-wise."""
    if cfg.num_experts > 1:
        return _moe_mlp(lp, y, cfg, token_mask=token_mask)[0]
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
    """[B, S] ids -> [B, S, vocab] float32 logits (causal), on one device.
    The MoE layers route every token (unmasked, as JAX's ``forward``)."""
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


#: (param, HF name under ``model.layers.{i}.``, transposed) of a dense layer
_HF_LAYER = (("attn_norm", "scale", "input_layernorm.weight", False),
             ("wq", "w", "self_attn.q_proj.weight", True),
             ("wk", "w", "self_attn.k_proj.weight", True),
             ("wv", "w", "self_attn.v_proj.weight", True),
             ("wo", "w", "self_attn.o_proj.weight", True),
             ("mlp_norm", "scale", "post_attention_layernorm.weight", False),
             ("w_gate", "w", "mlp.gate_proj.weight", True),
             ("w_up", "w", "mlp.up_proj.weight", True),
             ("w_down", "w", "mlp.down_proj.weight", True))


def from_hf_state_dict(state: dict, cfg: DecoderConfig) -> dict:
    """A HuggingFace ``LlamaForCausalLM`` state dict (torch tensors of any
    dtype, bfloat16 included, or numpy arrays) as this model's float32 param
    tree, as JAX's import makes it: linear weights transposed from ``[out,
    in]`` to ``[in, out]``, and the embedding as the head where the dict has
    no ``lm_head.weight`` (tied embeddings). Each stacked leaf is filled
    layer by layer, so the float32 tree is never held twice."""
    if cfg.num_experts > 1:
        raise ValueError("from_hf_state_dict maps dense Llama checkpoints; MoE configs unsupported")

    def t(name, transpose=False):
        return cm.hf_tensor(state, name, transpose)

    layers: dict = {}
    for i in range(cfg.layers):
        for param, leaf, hf_name, transpose in _HF_LAYER:
            v = t(f"model.layers.{i}.{hf_name}", transpose)
            if param not in layers:
                layers[param] = {leaf: torch.empty(cfg.layers, *v.shape)}
            layers[param][leaf][i] = v
    lm_head = "lm_head.weight" if "lm_head.weight" in state else "model.embed_tokens.weight"
    return {
        "embed": {"table": t("model.embed_tokens.weight")},
        "norm_out": {"scale": t("model.norm.weight")},
        "lm_head": {"w": t(lm_head, transpose=True)},
        "layers": layers,
    }


# -- sampling keys and the draw ------------------------------------------------

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def make_key(seed: int) -> int:
    """A sampling key from a seed (the role of ``jax.random.PRNGKey``)."""
    return _splitmix64(int(seed) & _M64)


def split_key(key: int) -> tuple[int, int]:
    """(next key, subkey), on the host (the role of ``jax.random.split``)."""
    return _splitmix64(key ^ 0x5851F42D4C957F2D), _splitmix64(key ^ 0x14057B7EF767814F)


def key_words(key: int) -> np.ndarray:
    """The key's low and high 32-bit words as int64: a step's key input."""
    return np.asarray([key & 0xFFFFFFFF, key >> 32], np.int64)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32): the constant in 16-bit
    halves, so no product reaches 2^63."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply) on int64 tensors in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def open_uniform(h: torch.Tensor) -> torch.Tensor:
    """The top 23 bits of 32-bit hashes as float32 uniforms strictly inside
    (0, 1): ``(x + 0.5) / 2^23`` is exact in float32 for x < 2^23 (with 24
    bits, ``2^24 - 0.5`` would round up to 1.0 and its Gumbel draw to
    +inf, which a masked -inf logit turns into NaN)."""
    return ((h >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def gumbel_noise(key: torch.Tensor, rows: int, vocab: int, device) -> torch.Tensor:
    """[rows, vocab] float32 standard Gumbel noise from a key's two words
    (an int64 tensor of 2): a hash of (key, row, index), as a uniform in
    (0, 1) (``open_uniform``), then ``-log(-log(u))``, finite."""
    key = key.to(device=device, dtype=torch.int64)
    row = torch.arange(rows, device=device, dtype=torch.int64)
    col = torch.arange(vocab, device=device, dtype=torch.int64)
    hr = _hash32(_hash32(row ^ key[0]) ^ key[1])
    h = _hash32(_hash32(col[None, :] ^ hr[:, None]) ^ key[0])
    return -torch.log(-torch.log(open_uniform(h)))


def select_token(logits: torch.Tensor, key: Union[int, torch.Tensor, None] = None,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Greedy (``temperature <= 0``) or temperature / top-k categorical
    sampling: [B, V] float32 logits -> [B] int32 ids. ``key``: a key
    (``make_key``/``split_key``) or its words as an int64 tensor; required
    when sampling. Top-k keeps every logit at or above the k-th largest
    (k clamped to the vocabulary), found by ``topk``, not a full sort."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if key is None:
        raise ConfigError("select_token: sampling (temperature > 0) needs a key")
    if not isinstance(key, torch.Tensor):
        key = torch.from_numpy(key_words(key))
    scaled = logits / temperature
    if top_k > 0:
        k = min(int(top_k), scaled.shape[-1])
        kth = scaled.topk(k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    noise = gumbel_noise(key, scaled.shape[0], scaled.shape[-1], scaled.device)
    return torch.argmax(scaled + noise, dim=-1).to(torch.int32)


def input_spec(cfg: DecoderConfig) -> dict:
    return {"input_ids": ("int32", ("seq",))}


# -- the contiguous KV cache (batched generation) ------------------------------


def head(params: dict, cfg: DecoderConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head: [..., dim] -> [..., vocab] float32 logits."""
    return cm.dense(params["lm_head"], cm.rms_norm(params["norm_out"], x, cfg.norm_eps)).float()


def last_rows(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Row b's hidden state at position clip(n[b] - 1, 0, T - 1)."""
    last = (n.long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), last]


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int, device=None) -> dict:
    """Cache layout for ragged batched generation, as in JAX:

    - ``k``, ``v``: [layers, batch, max_len, kv_heads, dh] bfloat16;
    - ``length``: the write cursor (one slot for every row), a 0-d int32;
    - ``lengths``: [batch] per-row true context lengths (RoPE positions;
      the padding slots between ``lengths[i]`` and ``prompt_len`` stay
      masked out of attention forever);
    - ``prompt_len``: width of the prefilled block (0 = pure stepwise)."""
    dh = cfg.dim // cfg.heads
    shape = (cfg.layers, batch, max_len, cfg.kv_heads, dh)
    zeros = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)  # noqa: E731
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "length": zeros(), "lengths": zeros(batch), "prompt_len": zeros()}


def prefill(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor, cache: dict,
            lengths: Optional[torch.Tensor] = None, return_logits: bool = False):
    """Fill a FRESH cache with right-padded prompts in one forward pass.

    input_ids: [B, T]; ``lengths``: [B] true prompt lengths (default T for
    every row). Attention masks each row's padding keys out, and the next
    token is read at position ``lengths[i] - 1``. K/V go into the cache as
    bfloat16, but this pass attends with the fresh (unrounded) k and v, as
    the JAX function does. The cursor lands at T. Returns (next ids [B]
    int32 -- or the last true position's logits [B, vocab] with
    ``return_logits`` -- , cache), the cache updated in place."""
    b, t = input_ids.shape
    dev = input_ids.device
    dh = cfg.dim // cfg.heads
    group = cfg.heads // cfg.kv_heads
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=dev)
    lengths = lengths.to(dev)
    positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    rope = rope_angles(positions, dh, cfg.rope_theta)
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()[None, None]
    token_mask = positions < lengths[:, None]  # [B, T] real tokens (MoE routing)
    mask = causal & token_mask[:, None, None, :]
    x = cm.embedding(params["embed"], input_ids)
    for i in range(num_layers(params)):
        lp = layer_params(params["layers"], i)
        y = cm.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q = apply_rope(cm.dense(lp["wq"], y).reshape(b, t, cfg.heads, dh), *rope)
        k = apply_rope(cm.dense(lp["wk"], y).reshape(b, t, cfg.kv_heads, dh), *rope)
        v = cm.dense(lp["wv"], y).reshape(b, t, cfg.kv_heads, dh)
        cache["k"][i, :, :t] = k.to(torch.bfloat16)
        cache["v"][i, :, :t] = v.to(torch.bfloat16)
        attn = cm.attention(q, k.repeat_interleave(group, dim=2),
                            v.repeat_interleave(group, dim=2), mask)
        x = x + cm.dense(lp["wo"], attn.reshape(b, t, cfg.heads * dh))
        x = x + _mlp(lp, cm.rms_norm(lp["mlp_norm"], x, cfg.norm_eps), cfg,
                     token_mask=token_mask)
    logits = head(params, cfg, last_rows(x, lengths))
    cache["length"].fill_(t)
    cache["lengths"].copy_(lengths)
    cache["prompt_len"].fill_(t)
    if return_logits:
        return logits, cache
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def decode_step(params: dict, cfg: DecoderConfig, token_ids: torch.Tensor, cache: dict,
                return_logits: bool = False):
    """One token per sequence: [B, 1] ids + cache -> ([B] next ids -- or
    [B, vocab] logits with ``return_logits`` -- , cache). The new K/V go in
    at the shared cursor; RoPE positions are the per-row ``lengths``; a row
    attends its real prompt keys (``k < lengths``) and the generated block
    (``prompt_len <= k <= cursor``), from the bfloat16 cache. The cursor and
    the lengths advance by one, in place. The MoE MLP is unmasked, as in
    JAX: every row, a batch's padding and finished rows too, takes expert
    capacity."""
    b = token_ids.shape[0]
    dev = token_ids.device
    dh = cfg.dim // cfg.heads
    group = cfg.heads // cfg.kv_heads
    pos = cache["length"]
    lengths = cache["lengths"]
    prompt_len = cache["prompt_len"]
    max_len = cache["k"].shape[2]
    rope = rope_angles(lengths[:, None], dh, cfg.rope_theta)
    ks = torch.arange(max_len, device=dev)[None, :]
    valid = ((ks < lengths[:, None]) | ((ks >= prompt_len) & (ks <= pos)))[:, None, None, :]
    at = pos.reshape(1).long()
    x = cm.embedding(params["embed"], token_ids)
    for i in range(num_layers(params)):
        lp = layer_params(params["layers"], i)
        y = cm.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q = apply_rope(cm.dense(lp["wq"], y).reshape(b, 1, cfg.heads, dh), *rope)
        k = apply_rope(cm.dense(lp["wk"], y).reshape(b, 1, cfg.kv_heads, dh), *rope)
        v = cm.dense(lp["wv"], y).reshape(b, 1, cfg.kv_heads, dh)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache.index_copy_(1, at, k.to(torch.bfloat16))
        v_cache.index_copy_(1, at, v.to(torch.bfloat16))
        attn = cm.attention(q, k_cache.repeat_interleave(group, dim=2),
                            v_cache.repeat_interleave(group, dim=2), valid)
        x = x + cm.dense(lp["wo"], attn.reshape(b, 1, cfg.heads * dh))
        x = x + _mlp(lp, cm.rms_norm(lp["mlp_norm"], x, cfg.norm_eps), cfg)
    logits = head(params, cfg, x[:, -1, :])
    pos.add_(1)
    lengths.add_(1)
    if return_logits:
        return logits, cache
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def generation_keys(key: int, max_new_tokens: int) -> np.ndarray:
    """The subkeys one generation draws with, split as JAX's ``generate``
    splits its key: row 0 for the prefill's token, row 1 + s for loop step
    s (step 0 emits the prefill's token and draws nothing). [max_new + 1,
    2] int64 words."""
    key, sub = split_key(key)
    subs = [sub]
    for _ in range(max_new_tokens):
        key, sub = split_key(key)
        subs.append(sub)
    return np.stack([key_words(k) for k in subs])


def emit(state: dict, nxt: torch.Tensor, eos_id: int) -> None:
    """One loop step's bookkeeping, in place on the generation state
    (``nxt``, ``done``, ``counts``, ``out``, ``step``): a row not yet done
    that did not pick EOS emits its token at column ``step``, others emit
    0; EOS marks the row done; the step advances."""
    done = state["done"]
    is_eos = nxt == eos_id
    keep = ~done & ~is_eos
    col = state["step"].reshape(1, 1).expand(nxt.shape[0], 1)
    state["out"].scatter_(1, col, torch.where(keep, nxt, 0)[:, None])
    state["counts"].add_(keep.to(torch.int32))
    done.logical_or_(is_eos)
    state["nxt"].copy_(nxt)
    state["step"].add_(1)


def generation_state(batch: int, max_new_tokens: int, device=None) -> dict:
    """The loop state of one generation (the JAX while-loop carry beside
    the cache)."""
    return {"nxt": torch.zeros(batch, dtype=torch.int32, device=device),
            "done": torch.zeros(batch, dtype=torch.bool, device=device),
            "counts": torch.zeros(batch, dtype=torch.int32, device=device),
            "out": torch.zeros(batch, max_new_tokens, dtype=torch.int32, device=device),
            "step": torch.zeros((), dtype=torch.int64, device=device)}


def start_generation(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor,
                     lengths: torch.Tensor, n_real: torch.Tensor, keys: torch.Tensor,
                     cache: dict, state: dict, *, eos_id: int, temperature: float,
                     top_k: int) -> None:
    """Prefill into ``cache``, pick the first token with ``keys[0]``, and
    run loop step 0 (its emission): the state is reset first, rows at or
    past ``n_real`` start done (batch padding never gates the exit)."""
    cache["k"].zero_()
    cache["v"].zero_()
    logits, _ = prefill(params, cfg, input_ids, cache, lengths=lengths, return_logits=True)
    nxt = select_token(logits, keys[0], temperature, top_k)
    b = input_ids.shape[0]
    state["done"].copy_(torch.arange(b, device=input_ids.device) >= n_real.reshape(()))
    state["counts"].zero_()
    state["out"].zero_()
    state["step"].zero_()
    emit(state, nxt, eos_id)


def continue_generation(params: dict, cfg: DecoderConfig, keys: torch.Tensor, cache: dict,
                        state: dict, *, eos_id: int, temperature: float, top_k: int) -> None:
    """One loop step after step 0: decode the last picked tokens at the top
    of the step, pick with ``keys[1 + step]``, emit."""
    logits, _ = decode_step(params, cfg, state["nxt"][:, None], cache, return_logits=True)
    key = keys.index_select(0, state["step"].reshape(1) + 1)[0]
    emit(state, select_token(logits, key, temperature, top_k), eos_id)


def generate(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor,
             lengths: torch.Tensor, max_new_tokens: int, eos_id: int = 2,
             n_real: Optional[int] = None, temperature: float = 0.0, top_k: int = 0,
             rng_key: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-sequence generation: prefill, then a loop that decodes at the
    TOP for steps >= 1 and exits early once every row is done (EOS), as the
    JAX ``while_loop`` does; op by op, reading ``all(done)`` on the host
    every step. ``temperature <= 0`` is greedy; otherwise temperature /
    top-k sampling from ``rng_key`` (``make_key``; default key 0), one
    split per step. Returns (tokens [B, max_new_tokens] int32, zero-padded
    after EOS, counts [B] of real tokens per row)."""
    b, t = input_ids.shape
    dev = input_ids.device
    keys = torch.from_numpy(generation_keys(make_key(0) if rng_key is None else rng_key,
                                            max_new_tokens)).to(dev)
    cache = init_kv_cache(cfg, b, t + max_new_tokens, dev)
    state = generation_state(b, max_new_tokens, dev)
    n = torch.tensor(b if n_real is None else int(n_real), device=dev)
    sample = dict(eos_id=eos_id, temperature=temperature, top_k=top_k)
    start_generation(params, cfg, input_ids, lengths.to(dev), n, keys, cache, state, **sample)
    for _ in range(1, max_new_tokens):
        if bool(state["done"].all()):
            break
        continue_generation(params, cfg, keys, cache, state, **sample)
    return state["out"], state["counts"]


register_model(
    ModelFamily(
        name="decoder_lm",
        make_config=make_config,
        init=init,
        apply=apply,
        input_spec=input_spec,
        extras={
            "forward": forward,
            "from_hf_state_dict": from_hf_state_dict,
            "llama3_8b": llama3_8b,
            "select_token": select_token,
            "init_kv_cache": init_kv_cache,
            "prefill": prefill,
            "decode_step": decode_step,
            "generate": generate,
        },
    )
)
