"""BERT-base sequence classifier: the flagship streaming-inference model.

Counterpart of ``arkflow_tpu/models/bert.py`` (``encode``, ``apply`` on
right-padded rows and ``apply_packed`` on token-packed rows). Standard
BERT-base shape by default: 12 layers, hidden 768, 12 heads, FFN 3072, vocab
30522. Params keep the JAX tree's layout -- the same nested paths, dense
``w`` stored ``[in, out]``, per-layer params stacked on a leading axis -- and
the layer scan is a Python loop over that axis. Right-padded rows attend
through the ragged kernel (``ops/ragged_attention.py``) when
``use_flash_attention`` is on and the bucket's seq is at least
``flash_min_seq``; packed rows through the segment kernel
(``ops/segment_attention.py``) when ``packed_flash`` is on; otherwise
through the plain masked attention.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from arkflow_tpu_torch.errors import ConfigError, not_ported
from arkflow_tpu_torch.models import common as cm
from arkflow_tpu_torch.models.registry import ModelFamily, register_model
from arkflow_tpu_torch.ops.ragged_attention import ragged_flash_attention
from arkflow_tpu_torch.ops.segment_attention import segment_flash_attention

_SOFTMAX_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: BertConfig fields of the JAX package that belong to paths not ported yet
_NOT_PORTED_FIELDS = ("flash_interpret",)


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ffn: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    num_labels: int = 2
    ln_eps: float = 1e-12
    #: attention via the ragged kernel. REQUIRES right-padding: the
    #: attention mask must be a contiguous prefix of ones (row sums become
    #: per-row lengths; ModelRunner checks this before the step). None =
    #: auto: ModelRunner resolves it to True on CUDA devices and False on
    #: the CPU; direct ``apply`` callers get the plain path unless they opt in.
    use_flash_attention: "bool | None" = None
    #: buckets with seq below this use the plain attention even when flash
    #: is on. None = no floor (the runner's auto rule leaves it at 0 until an
    #: H100 measurement says otherwise).
    flash_min_seq: "int | None" = None
    #: packed execution only: the block-diagonal attention through the
    #: segment kernel instead of the plain attention on a [P, 1, S, S] pair
    #: mask. None = auto: ModelRunner resolves it to True on CUDA and False
    #: on the CPU; direct ``apply_packed`` callers get the pair mask unless
    #: they opt in.
    packed_flash: "bool | None" = None
    #: softmax dtype of the plain attention ("float32" or "bfloat16")
    softmax_dtype: str = "float32"

    def __post_init__(self):
        if self.softmax_dtype not in _SOFTMAX_DTYPES:
            raise ConfigError(
                f"softmax_dtype {self.softmax_dtype!r} invalid (float32/bfloat16)")


def make_config(**overrides) -> BertConfig:
    for name in overrides:
        if name in _NOT_PORTED_FIELDS:
            raise not_ported(f"bert_classifier model_config.{name}")
    known = {f.name for f in dataclasses.fields(BertConfig)}
    unknown = sorted(set(overrides) - known)
    if unknown:
        raise ConfigError(f"bert_classifier: unknown model_config keys {unknown}")
    return BertConfig(**overrides)


def init(gen: torch.Generator, cfg: BertConfig) -> dict:
    """Params on the CPU in float32, drawn from ``gen``: the JAX ``init``'s
    shapes and distributions (the numbers differ: another generator)."""
    params = {
        "embed": {
            "word": cm.embedding_init(gen, cfg.vocab_size, cfg.hidden),
            "position": cm.embedding_init(gen, cfg.max_positions, cfg.hidden),
            "token_type": cm.embedding_init(gen, cfg.type_vocab, cfg.hidden),
            "ln": cm.layer_norm_init(cfg.hidden),
        },
        "pooler": cm.dense_init(gen, cfg.hidden, cfg.hidden),
        "classifier": cm.dense_init(gen, cfg.hidden, cfg.num_labels),
    }
    layers = [
        {
            "q": cm.dense_init(gen, cfg.hidden, cfg.hidden),
            "k": cm.dense_init(gen, cfg.hidden, cfg.hidden),
            "v": cm.dense_init(gen, cfg.hidden, cfg.hidden),
            "attn_out": cm.dense_init(gen, cfg.hidden, cfg.hidden),
            "attn_ln": cm.layer_norm_init(cfg.hidden),
            "ffn_in": cm.dense_init(gen, cfg.hidden, cfg.ffn),
            "ffn_out": cm.dense_init(gen, cfg.ffn, cfg.hidden),
            "ffn_ln": cm.layer_norm_init(cfg.hidden),
        }
        for _ in range(cfg.layers)
    ]
    params["layers"] = cm.stack_layers(layers)
    return params


def encode(params: dict, cfg: BertConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor, *, positions: Optional[torch.Tensor] = None,
           pair_mask: Optional[torch.Tensor] = None,
           segments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S] ids/mask -> [B, S, hidden] bf16 encodings.

    ``positions``/``pair_mask``/``segments`` are the packed-execution hooks
    (``tpu/packing.py``): per-token position ids, and either a [B, 1, Sq, Sk]
    block-diagonal mask for the plain attention or per-token segment ids for
    the segment kernel. Either one turns the ragged kernel off: it reads
    prefix lengths, which cannot express segments.
    """
    b, s = input_ids.shape
    if positions is None:
        positions = torch.arange(s, device=input_ids.device)[None, :]
    x = (
        cm.embedding(params["embed"]["word"], input_ids)
        + cm.embedding(params["embed"]["position"], positions)
        + cm.embedding(params["embed"]["token_type"], torch.zeros_like(input_ids))
    )
    x = cm.layer_norm(params["embed"]["ln"], x, cfg.ln_eps)
    use_kernel = (pair_mask is None and segments is None and bool(cfg.use_flash_attention)
                  and s >= (cfg.flash_min_seq or 0))
    if segments is not None:
        segments = segments.to(torch.int32).contiguous()
    elif use_kernel:
        # contiguous-prefix masks: the row sums are the lengths
        lengths = attention_mask.sum(dim=1, dtype=torch.int32)
    elif pair_mask is not None:
        mask = pair_mask
    else:
        mask = attention_mask[:, None, None, :].bool()  # [B, 1, 1, Sk]
    softmax_dtype = _SOFTMAX_DTYPES[cfg.softmax_dtype]
    h = cfg.heads
    dh = cfg.hidden // h

    def attend(q, k, v):
        if segments is not None:
            # [B, S, H, D] views as in the ragged case below
            out = segment_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), segments)
            return out.transpose(1, 2)
        if use_kernel:
            # [B, S, H, D] -> [B, H, S, D] views: the kernel reads them in
            # place through their strides, and its output keeps q's layout
            out = ragged_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), lengths)
            return out.transpose(1, 2)
        return cm.attention(q, k, v, mask, softmax_dtype=softmax_dtype)

    n_layers = next(iter(params["layers"]["q"].values())).shape[0]
    for i in range(n_layers):
        lp = cm.layer_params(params["layers"], i)
        q = cm.dense(lp["q"], x).reshape(b, s, h, dh)
        k = cm.dense(lp["k"], x).reshape(b, s, h, dh)
        v = cm.dense(lp["v"], x).reshape(b, s, h, dh)
        attn = attend(q, k, v).reshape(b, s, cfg.hidden)
        x = cm.layer_norm(lp["attn_ln"], x + cm.dense(lp["attn_out"], attn), cfg.ln_eps)
        ff = cm.dense(lp["ffn_out"], cm.gelu(cm.dense(lp["ffn_in"], x)))
        x = cm.layer_norm(lp["ffn_ln"], x + ff, cfg.ln_eps)
    return x


def _classify(params: dict, cls: torch.Tensor) -> dict:
    pooled = torch.tanh(cm.dense(params["pooler"], cls))
    logits = cm.dense(params["classifier"], pooled).float()
    probs = torch.softmax(logits, dim=-1)
    return {
        "label": torch.argmax(logits, dim=-1).to(torch.int32),
        "score": probs.max(dim=-1).values,
        "logits": logits,
    }


def apply(params: dict, cfg: BertConfig, *, input_ids: torch.Tensor,
          attention_mask: torch.Tensor) -> dict:
    x = encode(params, cfg, input_ids, attention_mask)
    return _classify(params, x[:, 0, :])


def apply_packed(params: dict, cfg: BertConfig, *, input_ids: torch.Tensor,
                 segment_ids: torch.Tensor, position_ids: torch.Tensor,
                 example_row: torch.Tensor, example_pos: torch.Tensor) -> dict:
    """Packed forward (``tpu/packing.py`` layout): [P, S] rows holding E
    examples. Attention is block-diagonal on ``segment_ids`` (0 = dead),
    position embeddings follow ``position_ids``, and each example's [CLS]
    encoding is gathered at (example_row, example_pos): outputs are [E], in
    example order. The encodings of dead positions differ by path (uniform
    attention under the pair mask, exact zeros from the kernel) and are
    never gathered."""
    seg = segment_ids
    live = (seg > 0).to(torch.int32)
    if cfg.packed_flash and input_ids.shape[1] >= (cfg.flash_min_seq or 0):
        x = encode(params, cfg, input_ids, live, positions=position_ids, segments=seg)
    else:
        pair = (seg[:, None, :] == seg[:, :, None]) & (seg > 0)[:, None, :]
        x = encode(params, cfg, input_ids, live, positions=position_ids,
                   pair_mask=pair[:, None, :, :])  # [P, 1, Sq, Sk]
    return _classify(params, x[example_row.long(), example_pos.long()])


def from_hf_state_dict(state: dict, cfg: BertConfig) -> dict:
    """A HuggingFace ``BertForSequenceClassification`` state dict (torch
    tensors of any dtype, bfloat16 included, or numpy arrays) as this
    model's float32 param tree: linear weights transposed from ``[out, in]``
    to ``[in, out]``, the layers stacked."""

    def t(name, transpose=False):
        return cm.hf_tensor(state, name, transpose)

    def lin(prefix):
        return {"w": t(f"{prefix}.weight", transpose=True), "b": t(f"{prefix}.bias")}

    def ln(prefix):
        return {"scale": t(f"{prefix}.weight"), "bias": t(f"{prefix}.bias")}

    e = "bert.embeddings"
    layers = []
    for i in range(cfg.layers):
        p = f"bert.encoder.layer.{i}"
        layers.append({
            "q": lin(f"{p}.attention.self.query"),
            "k": lin(f"{p}.attention.self.key"),
            "v": lin(f"{p}.attention.self.value"),
            "attn_out": lin(f"{p}.attention.output.dense"),
            "attn_ln": ln(f"{p}.attention.output.LayerNorm"),
            "ffn_in": lin(f"{p}.intermediate.dense"),
            "ffn_out": lin(f"{p}.output.dense"),
            "ffn_ln": ln(f"{p}.output.LayerNorm"),
        })
    return {
        "embed": {
            "word": {"table": t(f"{e}.word_embeddings.weight")},
            "position": {"table": t(f"{e}.position_embeddings.weight")},
            "token_type": {"table": t(f"{e}.token_type_embeddings.weight")},
            "ln": ln(f"{e}.LayerNorm"),
        },
        "layers": cm.stack_layers(layers),
        "pooler": lin("bert.pooler.dense"),
        "classifier": lin("classifier"),
    }


def input_spec(cfg: BertConfig) -> dict:
    return {"input_ids": ("int32", ("seq",)), "attention_mask": ("int32", ("seq",))}


def packed_input_spec(cfg: BertConfig) -> dict:
    """Inputs of packed execution: the ``seq`` arrays share the packed-row
    dim P, the scalar ones the example dim E."""
    return {
        "input_ids": ("int32", ("seq",)),
        "segment_ids": ("int32", ("seq",)),
        "position_ids": ("int32", ("seq",)),
        "example_row": ("int32", ()),
        "example_pos": ("int32", ()),
    }


register_model(
    ModelFamily(
        name="bert_classifier",
        make_config=make_config,
        init=init,
        apply=apply,
        input_spec=input_spec,
        extras={"from_hf_state_dict": from_hf_state_dict, "apply_packed": apply_packed,
                "packed_input_spec": packed_input_spec},
    )
)
