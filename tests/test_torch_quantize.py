"""W8A8 int8 serving in the port (``arkflow_tpu_torch.models.quantize``):
the four single-device scenarios of ``tests/test_quantize.py`` on the port,
and the port against the JAX package on the same weights and inputs --
``quantize_dense`` bit for bit, ``dense_w8a8`` on the same quantized tree,
the int8 runners (BERT padded and packed, the decoder), a JAX-quantized tree
carried across, and an int8 ``gpu_inference`` stream."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import common as jcm
from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.models import quantize as jq
from arkflow_tpu.tpu.bucketing import BucketPolicy as JaxBucketPolicy
from arkflow_tpu.tpu.runner import ModelRunner as JaxModelRunner
from arkflow_tpu_torch.components import ensure_plugins_loaded
from arkflow_tpu_torch.config import StreamConfig
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.models import common as cm
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.models import quantize as q8
from arkflow_tpu_torch.runtime.stream import build_stream
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy
from arkflow_tpu_torch.tpu.runner import ModelRunner
from tests.test_torch_runner import _packed_layout
from tests.test_tpu_layer import TINY_BERT

ensure_plugins_loaded()

#: the JAX int8 decoder test's shape
TINY_DECODER = {"vocab_size": 128, "dim": 32, "layers": 2, "heads": 4, "kv_heads": 2,
                "ffn": 48, "max_seq": 64}
LOGIT_ATOL = 1.0 / 64  # the bf16 floor of the parity rules
INT8_LOGIT_ATOL = 1e-2  # the int8 floor of the parity rules
TIE_MARGIN = 0.05


def _jax_host(family: str, cfg: dict, seed: int = 0):
    fam = jax_get_model(family)
    return jax.device_get(fam.init(jax.random.PRNGKey(seed), fam.make_config(**cfg)))


def _bert_inputs(seed: int, rows: int = 6, width: int = 16):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, width + 1, rows)
    mask = (np.arange(width)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(4, TINY_BERT["vocab_size"], (rows, width)).astype(np.int32) * mask
    return {"input_ids": ids, "attention_mask": mask}


def _assert_logits_and_labels(got, want, atol):
    np.testing.assert_allclose(got["logits"], want["logits"], atol=atol, rtol=0)
    top2 = np.sort(want["logits"], axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > TIE_MARGIN
    np.testing.assert_array_equal(got["label"][tie_free], want["label"][tie_free])


# -- the scenarios of tests/test_quantize.py -----------------------------------


def test_dense_w8a8_matches_float_dense():
    p = cm.dense_init(torch.Generator().manual_seed(0), 256, 128)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 256)).astype(np.float32))
    ref = cm.dense(p, x, dtype=torch.float32)
    before = q8.int8_products.value
    got = q8.dense_w8a8(q8.quantize_dense(p), x, dtype=torch.float32)
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    assert rel < 0.02, rel
    assert q8.int8_products.value == before + 1


def test_quantize_walks_stacked_layers():
    """Stacked dense params ([L, in, out]) quantize with the stack axis
    riding along, and the other float leaves become bf16."""
    fam = get_model("bert_classifier")
    cfg = fam.make_config(**TINY_BERT)
    qparams, n = q8.quantize_for_serving(fam.init(torch.Generator().manual_seed(0), cfg))
    # q/k/v/attn_out/ffn_in/ffn_out in the layer stack, the pooler, the classifier
    assert n == 8
    lw = qparams["layers"]["q"]
    assert set(lw) == {"w_q", "w_scale", "b"}
    assert lw["w_q"].dtype == torch.int8 and lw["w_q"].dim() == 3
    assert lw["w_q"][0].stride(0) == 1  # each layer's weight column-major
    assert lw["w_scale"].dtype == torch.float32
    assert tuple(lw["w_scale"].shape) == (cfg.layers, 1, cfg.hidden)
    assert lw["b"].dtype == torch.bfloat16
    assert qparams["embed"]["word"]["table"].dtype == torch.bfloat16


def test_runner_int8_serving_matches_f32_labels():
    f32 = ModelRunner("bert_classifier", TINY_BERT, buckets=BucketPolicy((4,), (16,)),
                      device="cpu")
    i8 = ModelRunner("bert_classifier", TINY_BERT, buckets=BucketPolicy((4,), (16,)),
                     device="cpu", serving_dtype="int8")
    ids = np.random.RandomState(0).randint(1, 512, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    a = f32.infer_sync({"input_ids": ids, "attention_mask": mask})
    before = q8.int8_products.value
    b = i8.infer_sync({"input_ids": ids, "attention_mask": mask})
    np.testing.assert_allclose(a["logits"], b["logits"], atol=0.05)
    np.testing.assert_array_equal(a["label"], b["label"])
    # six dense layers a layer, then the pooler and the classifier
    assert q8.int8_products.value - before == 6 * TINY_BERT["layers"] + 2


def test_runner_int8_decoder_serving_runs():
    """The generic walk covers the decoder (wq/wk/wv/wo/SwiGLU/lm_head), and
    the decoder reads its depth from an int8 tree."""
    runner = ModelRunner("decoder_lm", TINY_DECODER, buckets=BucketPolicy((2,), (16,)),
                         device="cpu", serving_dtype="int8")
    assert "w_q" in runner.params["layers"]["wq"] and "w" not in runner.params["lm_head"]
    out = runner.infer_sync({"input_ids": np.ones((2, 16), np.int32)})
    assert out["logits"].shape == (2, 16, TINY_DECODER["vocab_size"])
    assert np.all(np.isfinite(out["logits"]))


# -- the port against JAX ----------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 40), (3, 24, 16)])
def test_quantize_dense_is_bitwise_jax(shape):
    """The same f32 weights (a stacked one too) give the same int8 codes and
    the same scales; a zero column takes the 1e-8 floor in both."""
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32) * 0.3
    w[..., 1] = 0.0
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jax.device_get(jq.quantize_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}))
    got = q8.quantize_dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(want["w_q"]))
    np.testing.assert_array_equal(got["w_scale"].numpy(), np.asarray(want["w_scale"]))
    np.testing.assert_array_equal(got["b"].float().numpy(),
                                  np.asarray(want["b"]).astype(np.float32))


@pytest.mark.parametrize("rows,k,n", [(16, 256, 128), (4, 32, 2), (20, 64, 48)])
def test_dense_w8a8_matches_jax_on_the_same_tree(rows, k, n):
    """The JAX quantized tree, carried across, through both ``dense_w8a8``
    in f32: the int8 products are exact, so only the dequantize's rounding
    differs. Rows below 17 and N = 2 take the padded product."""
    jp = jcm.dense_init(jax.random.PRNGKey(rows), k, n)
    jp["b"] = jax.random.normal(jax.random.PRNGKey(rows + 1), (n,)) * 0.1
    jqp = jq.quantize_dense(jp)
    x = np.random.default_rng(k).standard_normal((rows, k)).astype(np.float32)
    want = np.asarray(jq.dense_w8a8(jqp, jnp.asarray(x), dtype=jnp.float32))
    got = q8.dense_w8a8(params_from_jax(jax.device_get(jqp)), torch.from_numpy(x),
                        dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_int8_matmul_pads_exactly():
    """Rows, inner and column sizes off ``torch._int_mm``'s CUDA limits
    (here on the CPU) give the exact integer product, with leading dims."""
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (2, 3, 13)).astype(np.int8)
    w = rng.integers(-127, 128, (13, 2)).astype(np.int8)
    got = q8.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 3, 2)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("packed", [False, True])
def test_int8_bert_runner_matches_jax_int8_runner(packed):
    """The port's int8 runner against the JAX int8 runner on the JAX init's
    weights, padded and packed: logits within the int8 floor."""
    host = _jax_host("bert_classifier", TINY_BERT, seed=3)
    batch, seq = (4, 8), (16, 32)
    if packed:
        _, inputs = _packed_layout(6, 24, 24, 32)
        buckets, jbuckets = (BucketPolicy(batch, seq, example_scale=4),
                             JaxBucketPolicy(batch, seq, example_scale=4))
    else:
        inputs = _bert_inputs(4, rows=7, width=24)
        buckets, jbuckets = BucketPolicy(batch, seq), JaxBucketPolicy(batch, seq)
    want = JaxModelRunner("bert_classifier", TINY_BERT, buckets=jbuckets, host_params=host,
                          serving_dtype="int8", packed=packed).infer_sync(inputs)
    runner = ModelRunner("bert_classifier", TINY_BERT, buckets=buckets, device="cpu",
                         host_params=params_from_jax(host), serving_dtype="int8",
                         packed=packed)
    got = runner.infer_sync(inputs)
    _assert_logits_and_labels(got, want, INT8_LOGIT_ATOL)


def test_int8_decoder_runner_matches_jax_int8_runner():
    """The decoder's full-sequence logits at int8, against the same forward
    of the JAX package run op by op (eager) within the decoder's floor (1/64,
    and one bf16 step of each logit's magnitude), and against the jitted JAX
    runner no further than that runner lies from its own eager forward, plus
    1/64: XLA's fusions round the bf16 activations elsewhere, and a rounding
    difference that moves an activation across an int8 code boundary moves
    the product by a whole code (0.055 at this shape, logits up to ~1.8)."""
    host = _jax_host("decoder_lm", TINY_DECODER, seed=1)
    ids = np.random.default_rng(2).integers(3, 128, (2, 16)).astype(np.int32)
    want = JaxModelRunner("decoder_lm", TINY_DECODER, buckets=JaxBucketPolicy((2,), (16,)),
                          host_params=host, serving_dtype="int8").infer_sync({"input_ids": ids})
    jtree, _ = jq.quantize_for_serving(jax.tree_util.tree_map(jnp.asarray, host))
    jfam = jax_get_model("decoder_lm")
    with jax.disable_jit():
        eager = np.asarray(jfam.apply(jtree, jfam.make_config(**TINY_DECODER),
                                      input_ids=jnp.asarray(ids))["logits"])
    got = ModelRunner("decoder_lm", TINY_DECODER, buckets=BucketPolicy((2,), (16,)),
                      device="cpu", host_params=params_from_jax(host),
                      serving_dtype="int8").infer_sync({"input_ids": ids})
    np.testing.assert_allclose(got["logits"], eager, atol=LOGIT_ATOL, rtol=2.0**-7)
    jit_spread = float(np.abs(want["logits"] - eager).max())
    assert float(np.abs(got["logits"] - want["logits"]).max()) <= jit_spread + LOGIT_ATOL
    np.testing.assert_array_equal(got["next_token"], np.argmax(got["logits"][:, -1], axis=-1))


def test_jax_quantized_tree_serves_like_the_ports_own():
    """A tree the JAX package quantized, carried across by
    ``params_from_jax``, serves the same logits as the port's quantization
    of the converted float tree: the two trees are equal leaf for leaf."""
    host = _jax_host("bert_classifier", TINY_BERT, seed=4)
    jtree, jn = jq.quantize_for_serving(jax.tree_util.tree_map(jnp.asarray, host))
    carried = params_from_jax(jax.device_get(jtree))
    own, n = q8.quantize_for_serving(params_from_jax(host))
    assert n == jn == 8

    def leaves(tree, path=()):
        for key, val in tree.items():
            yield from leaves(val, path + (key,)) if isinstance(val, dict) else [(path + (key,), val)]

    a, b = dict(leaves(carried)), dict(leaves(own))
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key
    inputs = _bert_inputs(9)
    outs = [ModelRunner("bert_classifier", TINY_BERT, buckets=BucketPolicy((8,), (16,)),
                        device="cpu", host_params=tree).infer_sync(inputs)
            for tree in (carried, own)]
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_int8_gpu_inference_stream_on_the_cpu():
    """``generate -> memory buffer -> gpu_inference(serving_dtype: int8) ->
    sink``: every row, in order, through int8 products; labels as the bf16
    stream's on its tie-free rows."""
    payloads = ["ok", "sensor reading looks fine", "pressure spike on line four, check valve",
                " ".join(f"token{i}" for i in range(40))]

    def run(dtype: str):
        cfg = {"name": "s", "input": {"type": "generate", "payloads": payloads,
                                      "batch_size": 4, "count": 22},
               "buffer": {"type": "memory", "capacity": 8, "timeout": "10ms"},
               "pipeline": {"thread_num": 2, "processors": [{
                   "type": "gpu_inference", "model": "bert_classifier",
                   "model_config": TINY_BERT, "max_seq": 32, "batch_buckets": [4, 8],
                   "seq_buckets": [32], "outputs": ["label", "score", "logits"],
                   "serving_dtype": dtype, "device": "cpu", "warmup": True}]},
               "output": {"type": "drop"}}
        stream = build_stream(StreamConfig.from_mapping(cfg))
        rows, outs = [], []
        inner = stream.output.write

        async def write(batch):
            rows.extend(batch.to_binary())
            outs.append({k: batch.column(k) for k in ("label", "logits")})
            await inner(batch)

        stream.output.write = write
        asyncio.run(stream.run(asyncio.Event()))
        assert stream.errors == 0 and stream.rows_out == 22
        return rows, {k: np.concatenate([o[k] for o in outs]) for k in ("label", "logits")}

    before = q8.int8_products.value
    rows, got = run("int8")
    assert q8.int8_products.value > before
    assert rows == [payloads[i % 4].encode() for n in (4,) * 5 + (2,) for i in range(n)]
    _, want = run("bfloat16")
    np.testing.assert_allclose(got["logits"], want["logits"], atol=0.05, rtol=0)
    top2 = np.sort(want["logits"], axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > 2 * np.abs(got["logits"] - want["logits"]).max()
    np.testing.assert_array_equal(got["label"][tie_free], want["label"][tie_free])
