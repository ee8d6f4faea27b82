"""ViT-B/16 image embedder (image ingest -> embedding -> vector sink).

Counterpart of ``arkflow_tpu/models/vit.py``. The patch embedding is a
reshape and one ``[P*P*C, D]`` dense product (the conv patch projection as
a dense layer); 12 pre-LN transformer layers on the plain attention (the
JAX model calls no kernel here either); the CLS row of the final layer norm
is the embedding. Params keep the JAX tree's layout: dense ``w`` stored
``[in, out]``, ``cls`` ``[1, 1, D]``, ``pos`` ``[1, N + 1, D]``, the layers
stacked on a leading axis.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import common as cm
from arkflow_tpu_torch.models.registry import ModelFamily, register_model


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch: int = 16
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ffn: int = 3072
    channels: int = 3

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch) ** 2


def make_config(**overrides) -> ViTConfig:
    unknown = sorted(set(overrides) - {f.name for f in dataclasses.fields(ViTConfig)})
    if unknown:
        raise ConfigError(f"vit_embedder: unknown model_config keys {unknown}")
    return ViTConfig(**overrides)


def init(gen: torch.Generator, cfg: ViTConfig) -> dict:
    """Params on the CPU in float32, drawn from ``gen``: the JAX ``init``'s
    shapes and distributions (the numbers differ: another generator)."""
    d = cfg.hidden
    params = {
        "patch_embed": cm.dense_init(gen, cfg.patch * cfg.patch * cfg.channels, d),
        "cls": torch.randn(1, 1, d, generator=gen) * 0.02,
        "pos": torch.randn(1, cfg.num_patches + 1, d, generator=gen) * 0.02,
        "ln_out": cm.layer_norm_init(d),
    }
    params["layers"] = cm.stack_layers([
        {
            "ln1": cm.layer_norm_init(d),
            "q": cm.dense_init(gen, d, d),
            "k": cm.dense_init(gen, d, d),
            "v": cm.dense_init(gen, d, d),
            "attn_out": cm.dense_init(gen, d, d),
            "ln2": cm.layer_norm_init(d),
            "ffn_in": cm.dense_init(gen, d, cfg.ffn),
            "ffn_out": cm.dense_init(gen, cfg.ffn, d),
        }
        for _ in range(cfg.layers)
    ])
    return params


def _patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, P*P*C] by reshape and permute, each patch
    flattened in (row, col, channel) order."""
    b, h, w, c = images.shape
    p = cfg.patch
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def apply(params: dict, cfg: ViTConfig, *, images: torch.Tensor) -> dict:
    """images: [B, H, W, C] float32 in [0, 1] -> {"embedding": [B, hidden]
    float32}. The images are cast to bf16 before the patch embedding, as
    the JAX model does."""
    b = images.shape[0]
    x = cm.dense(params["patch_embed"], _patchify(images.to(torch.bfloat16), cfg))
    cls = params["cls"].to(x.dtype).expand(b, 1, cfg.hidden)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(x.dtype)
    s = x.shape[1]
    h, dh = cfg.heads, cfg.hidden // cfg.heads
    n_layers = params["layers"]["q"]["w"].shape[0]
    for i in range(n_layers):
        lp = cm.layer_params(params["layers"], i)
        y = cm.layer_norm(lp["ln1"], x)
        q = cm.dense(lp["q"], y).reshape(b, s, h, dh)
        k = cm.dense(lp["k"], y).reshape(b, s, h, dh)
        v = cm.dense(lp["v"], y).reshape(b, s, h, dh)
        x = x + cm.dense(lp["attn_out"], cm.attention(q, k, v).reshape(b, s, cfg.hidden))
        y = cm.layer_norm(lp["ln2"], x)
        x = x + cm.dense(lp["ffn_out"], cm.gelu(cm.dense(lp["ffn_in"], y)))
    return {"embedding": cm.layer_norm(params["ln_out"], x)[:, 0, :].float()}


def input_spec(cfg: ViTConfig) -> dict:
    return {"images": ("float32", (cfg.image_size, cfg.image_size, cfg.channels))}


def from_hf_state_dict(state: dict, cfg: ViTConfig) -> dict:
    """A HuggingFace ViT state dict as this model's float32 param tree:
    ``ViTForImageClassification`` keys (``vit.``-prefixed) or bare
    ``ViTModel`` keys (``embeddings.``/``encoder.``). The conv patch
    projection ``[D, C, P, P]`` maps onto the dense patch embedding in the
    patches' (row, col, channel) order: ``w[(i*P + j)*C + c, d] =
    conv_w[d, c, i, j]``, i.e. ``conv_w.permute(2, 3, 1, 0).reshape(P*P*C, D)``."""
    prefixed = any(k.startswith("vit.") for k in state)

    def t(name, transpose=False):
        return cm.hf_tensor(state, name if prefixed else name[len("vit."):], transpose)

    conv_w = t("vit.embeddings.patch_embeddings.projection.weight")
    patch_w = conv_w.permute(2, 3, 1, 0).reshape(-1, cfg.hidden).contiguous()
    layers = []
    for i in range(cfg.layers):
        p = f"vit.encoder.layer.{i}"
        layers.append({
            "ln1": {"scale": t(f"{p}.layernorm_before.weight"),
                    "bias": t(f"{p}.layernorm_before.bias")},
            "q": {"w": t(f"{p}.attention.attention.query.weight", True),
                  "b": t(f"{p}.attention.attention.query.bias")},
            "k": {"w": t(f"{p}.attention.attention.key.weight", True),
                  "b": t(f"{p}.attention.attention.key.bias")},
            "v": {"w": t(f"{p}.attention.attention.value.weight", True),
                  "b": t(f"{p}.attention.attention.value.bias")},
            "attn_out": {"w": t(f"{p}.attention.output.dense.weight", True),
                         "b": t(f"{p}.attention.output.dense.bias")},
            "ln2": {"scale": t(f"{p}.layernorm_after.weight"),
                    "bias": t(f"{p}.layernorm_after.bias")},
            "ffn_in": {"w": t(f"{p}.intermediate.dense.weight", True),
                       "b": t(f"{p}.intermediate.dense.bias")},
            "ffn_out": {"w": t(f"{p}.output.dense.weight", True),
                        "b": t(f"{p}.output.dense.bias")},
        })
    return {
        "patch_embed": {"w": patch_w, "b": t("vit.embeddings.patch_embeddings.projection.bias")},
        "cls": t("vit.embeddings.cls_token"),
        "pos": t("vit.embeddings.position_embeddings"),
        "ln_out": {"scale": t("vit.layernorm.weight"), "bias": t("vit.layernorm.bias")},
        "layers": cm.stack_layers(layers),
    }


register_model(
    ModelFamily(
        name="vit_embedder",
        make_config=make_config,
        init=init,
        apply=apply,
        input_spec=input_spec,
        extras={"from_hf_state_dict": from_hf_state_dict},
    )
)
