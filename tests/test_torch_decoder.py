"""The port's decoder LM against the JAX package's on the same weights
(JAX-initialised, converted with ``params_from_jax``) and the same numpy
inputs, at the JAX suites' TINY shape: ``rms_norm``, ``_rope``, ``forward``
and ``apply``; MoE's config and contiguous-cache paths (the rest of MoE is
in ``tests/test_torch_moe.py``); the parts that stay unported raise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import common as jcm
from arkflow_tpu.models import decoder as jdec
from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu_torch.convert import params_from_jax, params_to_numpy
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import common as cm
from arkflow_tpu_torch.models import decoder as dec
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.tpu.tokenizer import HashTokenizer

TINY = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, ffn=96, max_seq=64)
LOGIT_ATOL = 1.0 / 64  # the bf16 floor: both packages run the dense layers in bf16


@pytest.fixture(scope="module")
def tiny():
    fam = jax_get_model("decoder_lm")
    jcfg = fam.make_config(**TINY)
    jparams = fam.init(jax.random.PRNGKey(0), jcfg)
    host = jax.device_get(jparams)
    return fam, jcfg, jparams, get_model("decoder_lm").make_config(**TINY), params_from_jax(host)


def test_rms_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32) * 3
    scale = rng.rand(64).astype(np.float32) + 0.5
    want = np.asarray(jcm.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5))
    got = cm.rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = cm.rms_norm(cm.rms_norm_init(64), xb, 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(),
        np.asarray(jcm.rms_norm(jcm.rms_norm_init(64), jnp.asarray(x, jnp.bfloat16), 1e-5),
                   np.float32), atol=1.0 / 64)


@pytest.mark.parametrize("dh,theta", [(16, 500000.0), (128, 500000.0), (64, 10000.0)])
def test_rope_matches_jax(dh, theta):
    """Angles in float32 as the JAX code computes them; ``theta ** (i/dh)``
    may differ by an ulp of float32, far below the bf16 floor."""
    rng = np.random.RandomState(dh)
    x = rng.randn(2, 7, 3, dh).astype(np.float32)
    pos = (rng.randint(0, 640, (2, 7))).astype(np.int32)
    want = np.asarray(jdec._rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = dec._rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    wb = np.asarray(jdec._rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), theta), np.float32)
    gb = dec._rope(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos), theta)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), wb, atol=1.0 / 64, rtol=0)


def test_forward_and_apply_match_jax(tiny):
    fam, jcfg, jparams, cfg, params = tiny
    ids = np.random.RandomState(1).randint(0, TINY["vocab_size"], (3, 11)).astype(np.int32)
    want = np.asarray(fam.extras["forward"](jparams, jcfg, jnp.asarray(ids)))
    got = dec.forward(params, cfg, torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (3, 11, TINY["vocab_size"])
    # the logits leave a bf16 matmul in both packages, so beside the 1/64
    # floor each may sit one bf16 step (2**-7 of its magnitude) apart
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=2.0**-7)
    out = get_model("decoder_lm").apply(params, cfg, input_ids=torch.from_numpy(ids))
    jout = fam.apply(jparams, jcfg, input_ids=jnp.asarray(ids))
    top2 = np.sort(want[:, -1], axis=-1)
    tie_free = (top2[:, -1] - top2[:, -2]) > 0.05
    np.testing.assert_array_equal(out["next_token"].numpy()[tie_free],
                                  np.asarray(jout["next_token"])[tie_free])
    assert out["next_token"].dtype == torch.int32


def test_params_from_jax_takes_the_decoder_tree_as_it_is(tiny):
    fam, jcfg, jparams, cfg, params = tiny
    host = jax.device_get(jparams)
    flat_j = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(host)[0]}
    back = params_to_numpy(params)
    flat_t = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert flat_j.keys() == flat_t.keys()
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_t[k], np.asarray(v))
    assert params["layers"]["wq"]["w"].shape == (2, 64, 64)  # stacked, [in, out]


def test_init_draws_the_jax_layout_in_bf16_with_f32_norms(tiny):
    fam, jcfg, jparams, cfg, _ = tiny
    params = dec.init(torch.Generator().manual_seed(0), cfg)
    shapes_j = {jax.tree_util.keystr(p): tuple(v.shape)
                for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat_t = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    shapes_t = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in flat_t.items()}
    assert shapes_t == shapes_j
    for path, leaf in flat_t.items():
        name = jax.tree_util.keystr(path)
        want = torch.float32 if "norm" in name else torch.bfloat16
        assert leaf.dtype == want, name
    w = params["layers"]["w_up"]["w"].float()
    bound = 1 / np.sqrt(TINY["dim"])
    assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3
    assert abs(float(params["embed"]["table"].float().std()) - 0.02) < 0.003
    again = dec.init(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(again["lm_head"]["w"], params["lm_head"]["w"])


def test_llama3_8b_is_the_jax_shape():
    assert dataclasses.asdict(dec.llama3_8b()) == dataclasses.asdict(jdec.llama3_8b())
    assert get_model("decoder_lm").extras["llama3_8b"]() == dec.llama3_8b()


@pytest.mark.parametrize("overrides", [{"use_ring_attention": True}, {"remat": True}])
def test_unported_config_raises(overrides):
    with pytest.raises(ConfigError, match="not yet ported"):
        get_model("decoder_lm").make_config(**TINY, **overrides)


@pytest.mark.parametrize("overrides", [{"num_experts": 4}])
def test_moe_config_is_ported(overrides):
    """MoE builds with JAX's defaults (capacity 1.25, aux weights 0.01 and
    1e-3) and draws JAX's tree (``tests/test_torch_moe.py`` holds it)."""
    cfg = get_model("decoder_lm").make_config(**TINY, **overrides)
    jcfg = jax_get_model("decoder_lm").make_config(**TINY, **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    layers = dec.init(torch.Generator().manual_seed(0), cfg)["layers"]
    assert set(layers["experts"]) == {"w_gate", "w_up", "w_down"} and "w_up" not in layers


def test_unknown_config_key_raises():
    with pytest.raises(ConfigError, match="unknown"):
        get_model("decoder_lm").make_config(hidden=3)


@pytest.mark.parametrize("name", ["prefill", "decode_step", "generate"])
def test_contiguous_cache_paths_run_moe(name):
    """The contiguous-cache paths with MoE (``num_experts`` 4, JAX's
    weights) give JAX's outputs: logits at 1/64 plus one bf16 step, tokens
    and counts exactly (``tests/test_torch_moe.py`` holds the rest)."""
    jfam = jax_get_model("decoder_lm")
    jcfg = jfam.make_config(**TINY, num_experts=4)
    jparams = jfam.init(jax.random.PRNGKey(0), jcfg)
    cfg, params = dec.DecoderConfig(**TINY, num_experts=4), params_from_jax(
        jax.device_get(jparams))
    ids = np.asarray([[3, 17, 42], [9, 4, 0]], np.int32)
    lens = np.asarray([3, 2], np.int32)
    ex = jfam.extras
    if name == "generate":
        want = ex["generate"](jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens), 4)
        got = dec.generate(params, cfg, torch.from_numpy(ids), torch.from_numpy(lens), 4)
        for g, w in zip(got, want):
            assert g.tolist() == np.asarray(w).tolist()
        return
    jl, jc = ex["prefill"](jparams, jcfg, jnp.asarray(ids), ex["init_kv_cache"](jcfg, 2, 6),
                           lengths=jnp.asarray(lens), return_logits=True)
    tl, tc = dec.prefill(params, cfg, torch.from_numpy(ids), dec.init_kv_cache(cfg, 2, 6),
                         lengths=torch.from_numpy(lens), return_logits=True)
    if name == "decode_step":
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, _ = ex["decode_step"](jparams, jcfg, jnp.asarray(tok), jc, return_logits=True)
        tl, _ = dec.decode_step(params, cfg, torch.from_numpy(tok), tc, return_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=2.0**-7)


def test_sampling_raises_and_greedy_is_argmax():
    """Greedy is the argmax whatever ``top_k``; sampling needs a key
    (``tests/test_torch_sampling.py`` holds the draws)."""
    logits = torch.tensor([[0.1, 3.0, -1.0], [2.0, 1.0, 0.0]])
    assert dec.select_token(logits).tolist() == [1, 0]
    assert dec.select_token(logits, top_k=5).tolist() == [1, 0]
    with pytest.raises(ConfigError, match="needs a key"):
        dec.select_token(logits, temperature=0.7)
    assert dec.select_token(logits, dec.make_key(0), 0.7, top_k=1).tolist() == [1, 0]


def test_decode_and_decode_column_match_jax():
    from arkflow_tpu.tpu.tokenizer import HashTokenizer as JaxHashTokenizer

    rows = [[5, 123, 7], [], [9], [128255, 2, 33, 4], []]
    flat = np.asarray([t for r in rows for t in r], np.int32)
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    tok, jtok = HashTokenizer(128256), JaxHashTokenizer(128256)
    col = tok.decode_column(flat, offsets)
    assert col.to_pylist() == [jtok.decode(r).encode() for r in rows]
    assert [tok.decode(r) for r in rows] == [jtok.decode(r) for r in rows]
    empty = tok.decode_column(np.zeros(0, np.int32), np.zeros(3, np.int64))
    assert empty.to_pylist() == [b"", b""]
