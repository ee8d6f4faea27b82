"""Port parity for the HuggingFace weight import: ``hf_tensor`` and
``from_hf_state_dict`` of ``decoder_lm``, ``bert_classifier`` and
``vit_embedder`` against the JAX package's on the same synthetic state
dicts (numpy float32, and torch bfloat16 as a checkpoint loads): each
imported tree equals JAX's bit for bit, and each forward on it is within
its floor of JAX's forward on JAX's tree. Nothing is downloaded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.models.common import hf_tensor as jax_hf_tensor
from arkflow_tpu_torch.convert import params_to_numpy
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.models.common import hf_tensor
from tests.test_torch_vit import emb_atol
from tests.test_tpu_layer import TINY_BERT

#: logits of the bf16 models: the bf16 floor of the parity rules
LOGIT_ATOL = 1.0 / 64
TINY_DEC = dict(vocab_size=64, dim=16, layers=2, heads=2, kv_heads=1, ffn=24, max_seq=32)
TINY_VIT = dict(image_size=32, patch=16, hidden=24, layers=2, heads=2, ffn=32)
KINDS = ["numpy", "torch_bf16"]


def _maker(seed: int, kind: str):
    rng = np.random.RandomState(seed)

    def w(*shape, ones=False):
        a = np.ones(shape, np.float32) if ones else rng.randn(*shape).astype(np.float32) * 0.05
        return torch.from_numpy(a).to(torch.bfloat16) if kind == "torch_bf16" else a
    return w


def llama_state(cfg: dict, kind: str, tied: bool = False) -> dict:
    w = _maker(0, kind)
    d, dh = cfg["dim"], cfg["dim"] // cfg["heads"]
    state = {"model.embed_tokens.weight": w(cfg["vocab_size"], d),
             "model.norm.weight": w(d, ones=True)}
    if not tied:
        state["lm_head.weight"] = w(cfg["vocab_size"], d)
    for i in range(cfg["layers"]):
        p = f"model.layers.{i}"
        state.update({
            f"{p}.input_layernorm.weight": w(d) + 1,
            f"{p}.post_attention_layernorm.weight": w(d) + 1,
            f"{p}.self_attn.q_proj.weight": w(cfg["heads"] * dh, d),
            f"{p}.self_attn.k_proj.weight": w(cfg["kv_heads"] * dh, d),
            f"{p}.self_attn.v_proj.weight": w(cfg["kv_heads"] * dh, d),
            f"{p}.self_attn.o_proj.weight": w(d, cfg["heads"] * dh),
            f"{p}.mlp.gate_proj.weight": w(cfg["ffn"], d),
            f"{p}.mlp.up_proj.weight": w(cfg["ffn"], d),
            f"{p}.mlp.down_proj.weight": w(d, cfg["ffn"]),
        })
    return state


def bert_state(cfg: dict, kind: str) -> dict:
    w = _maker(1, kind)
    h, f = cfg["hidden"], cfg["ffn"]
    e = "bert.embeddings"
    state = {f"{e}.word_embeddings.weight": w(cfg["vocab_size"], h),
             f"{e}.position_embeddings.weight": w(cfg["max_positions"], h),
             f"{e}.token_type_embeddings.weight": w(2, h),
             f"{e}.LayerNorm.weight": w(h) + 1, f"{e}.LayerNorm.bias": w(h),
             "bert.pooler.dense.weight": w(h, h), "bert.pooler.dense.bias": w(h),
             "classifier.weight": w(cfg["num_labels"], h), "classifier.bias": w(cfg["num_labels"])}
    for i in range(cfg["layers"]):
        p = f"bert.encoder.layer.{i}"
        for name, out_dim, in_dim in [("attention.self.query", h, h), ("attention.self.key", h, h),
                                      ("attention.self.value", h, h),
                                      ("attention.output.dense", h, h),
                                      ("intermediate.dense", f, h), ("output.dense", h, f)]:
            state[f"{p}.{name}.weight"] = w(out_dim, in_dim)
            state[f"{p}.{name}.bias"] = w(out_dim)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            state[f"{p}.{ln}.weight"] = w(h) + 1
            state[f"{p}.{ln}.bias"] = w(h)
    return state


def vit_state(cfg: dict, kind: str, prefixed: bool = True) -> dict:
    w = _maker(2, kind)
    d, p, c, f = cfg["hidden"], cfg["patch"], 3, cfg["ffn"]
    n = (cfg["image_size"] // p) ** 2
    pre = "vit." if prefixed else ""
    state = {f"{pre}embeddings.cls_token": w(1, 1, d),
             f"{pre}embeddings.position_embeddings": w(1, n + 1, d),
             f"{pre}embeddings.patch_embeddings.projection.weight": w(d, c, p, p),
             f"{pre}embeddings.patch_embeddings.projection.bias": w(d),
             f"{pre}layernorm.weight": w(d) + 1, f"{pre}layernorm.bias": w(d)}
    for i in range(cfg["layers"]):
        q = f"{pre}encoder.layer.{i}"
        for name, out_dim, in_dim in [("attention.attention.query", d, d),
                                      ("attention.attention.key", d, d),
                                      ("attention.attention.value", d, d),
                                      ("attention.output.dense", d, d),
                                      ("intermediate.dense", f, d), ("output.dense", d, f)]:
            state[f"{q}.{name}.weight"] = w(out_dim, in_dim)
            state[f"{q}.{name}.bias"] = w(out_dim)
        for ln in ("layernorm_before", "layernorm_after"):
            state[f"{q}.{ln}.weight"] = w(d) + 1
            state[f"{q}.{ln}.bias"] = w(d)
    return state


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def assert_trees_bitwise(port_tree: dict, jax_tree: dict) -> None:
    """Same paths, shapes, float32 leaves and bits."""
    got = dict(_leaves(params_to_numpy(port_tree)))
    want = {path: np.asarray(v) for path, v in _leaves(jax.device_get(jax_tree))}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert w.dtype == g.dtype == np.float32, path
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32), err_msg=str(path))


def _both(family: str, cfg: dict, state: dict):
    jfam, tfam = jax_get_model(family), get_model(family)
    jcfg, tcfg = jfam.make_config(**cfg), tfam.make_config(**cfg)
    jp = jfam.extras["from_hf_state_dict"](state, jcfg)
    tp = tfam.extras["from_hf_state_dict"](state, tcfg)
    return jfam, tfam, jcfg, tcfg, jp, tp


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_decoder_import_equals_jax_and_serves_the_same_logits(kind, tied):
    state = llama_state(TINY_DEC, kind, tied)
    jfam, tfam, jcfg, tcfg, jp, tp = _both("decoder_lm", TINY_DEC, state)
    assert_trees_bitwise(tp, jp)
    q = state["model.layers.0.self_attn.q_proj.weight"]
    q = q.float().numpy() if kind == "torch_bf16" else q
    np.testing.assert_array_equal(tp["layers"]["wq"]["w"][0].numpy(), q.T)
    head = tp["lm_head"]["w"].numpy()
    if tied:
        np.testing.assert_array_equal(head, tp["embed"]["table"].numpy().T)
    ids = np.random.RandomState(3).randint(1, TINY_DEC["vocab_size"], (2, 8)).astype(np.int32)
    want = np.asarray(jfam.extras["forward"](jp, jcfg, jnp.asarray(ids)))
    with torch.inference_mode():
        got = tfam.extras["forward"](tp, tcfg, torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 8, TINY_DEC["vocab_size"]) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_decoder_import_refuses_moe_as_jax_does():
    for fam in (jax_get_model("decoder_lm"), get_model("decoder_lm")):
        cfg = fam.make_config(num_experts=4)
        with pytest.raises(ValueError, match="MoE configs unsupported"):
            fam.extras["from_hf_state_dict"]({}, cfg)


@pytest.mark.parametrize("transpose", [False, True])
def test_hf_tensor_takes_torch_bf16_and_numpy(transpose):
    bf = {"w": torch.ones(3, 2, dtype=torch.bfloat16) * 1.5}
    out = hf_tensor(bf, "w", transpose=transpose)
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert out.shape == ((2, 3) if transpose else (3, 2))
    np.testing.assert_array_equal(out.numpy(), 1.5)
    arr = {"w": np.arange(6, dtype=np.float64).reshape(3, 2) / 7}
    got = hf_tensor(arr, "w", transpose=transpose).numpy()
    want = np.asarray(jax_hf_tensor(arr, "w", transpose=transpose))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # a new tensor: the import never aliases the caller's state dict
    f32 = {"w": torch.zeros(2, 2)}
    hf_tensor(f32, "w")[0, 0] = 1.0
    assert f32["w"][0, 0] == 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_bert_import_equals_jax_and_serves_the_same_logits(kind):
    cfg = {k: v for k, v in TINY_BERT.items()}
    jfam, tfam, jcfg, tcfg, jp, tp = _both("bert_classifier", cfg, bert_state(cfg, kind))
    assert_trees_bitwise(tp, jp)
    rng = np.random.RandomState(4)
    ids = rng.randint(4, cfg["vocab_size"], (4, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < np.array([16, 1, 9, 12])[:, None]).astype(np.int32)
    want = jfam.apply(jp, jcfg, input_ids=jnp.asarray(ids * mask), attention_mask=jnp.asarray(mask))
    with torch.inference_mode():
        got = tfam.apply(tp, tcfg, input_ids=torch.from_numpy(ids * mask),
                         attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("prefixed", [True, False], ids=["vit_prefix", "bare"])
def test_vit_import_equals_jax_with_the_whole_patch_map(kind, prefixed):
    state = vit_state(TINY_VIT, kind, prefixed)
    jfam, tfam, jcfg, tcfg, jp, tp = _both("vit_embedder", TINY_VIT, state)
    assert_trees_bitwise(tp, jp)
    pre = "vit." if prefixed else ""
    f32 = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v) for k, v in state.items()}
    conv = f32[f"{pre}embeddings.patch_embeddings.projection.weight"]  # [D, C, P, P]
    d, c, p = conv.shape[0], conv.shape[1], conv.shape[2]
    want = np.empty((p * p * c, d), np.float32)
    for i in range(p):
        for j in range(p):
            for ch in range(c):
                want[(i * p + j) * c + ch] = conv[:, ch, i, j]
    np.testing.assert_array_equal(tp["patch_embed"]["w"].numpy(), want)
    np.testing.assert_array_equal(tp["cls"].numpy(), f32[f"{pre}embeddings.cls_token"])
    np.testing.assert_array_equal(tp["pos"].numpy(), f32[f"{pre}embeddings.position_embeddings"])
    imgs = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    want_emb = np.asarray(jfam.apply(jp, jcfg, images=jnp.asarray(imgs))["embedding"])
    with torch.inference_mode():
        got_emb = tfam.apply(tp, tcfg, images=torch.from_numpy(imgs))["embedding"].numpy()
    assert got_emb.shape == (2, TINY_VIT["hidden"]) and np.isfinite(got_emb).all()
    np.testing.assert_allclose(got_emb, want_emb, atol=emb_atol(want_emb), rtol=0)
