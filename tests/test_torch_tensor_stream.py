"""The tensor families through ``gpu_inference``'s ``tensor_field`` on the
CPU, against the JAX package: ``extract_tensor`` on binary, fixed-size and
scalar columns with JAX's errors; the LSTM outlier and ViT embeddings as a
2-D column (the ports of ``tests/test_tpu_layer.py``'s tensor-field
tests), one graph key per batch bucket; the lifecycle keys on a tensor
stream; the integrity golden search for every family; and the embedding
lookup's clamp of out-of-range ids."""

import asyncio
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.config import StreamConfig as JaxStreamConfig
from arkflow_tpu.errors import ProcessError as JaxProcessError
from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.models import list_models as jax_list_models
from arkflow_tpu.runtime import build_stream as jax_build_stream
from arkflow_tpu.tpu.extract import extract_tensor as jax_extract_tensor
from arkflow_tpu.tpu.integrity import find_golden_reference as jax_find_golden
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Input, NoopAck
from arkflow_tpu_torch.config import StreamConfig
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError, EndOfInput, ProcessError
from arkflow_tpu_torch.models import get_model, list_models
from arkflow_tpu_torch.runtime.stream import build_stream
from arkflow_tpu_torch.tpu import checkpoint
from arkflow_tpu_torch.tpu.extract import extract_tensor
from arkflow_tpu_torch.tpu.integrity import MARGIN_FLOOR, find_golden_reference
from arkflow_tpu_torch.tpu.runner import ModelRunner
from arkflow_tpu_torch.tpu.swap import argmax_signature
from tests.test_integrity import FAMILY_CONFIGS
from tests.test_runtime import CollectOutput as JaxCollectOutput
from tests.test_torch_stream import Collect
from tests.test_tpu_layer import TINY_BERT

TINY_LSTM = {"features": 2, "hidden": 8, "latent": 4, "window": 8}
TINY_VIT = {"image_size": 32, "patch": 16, "hidden": 32, "layers": 1, "heads": 4, "ffn": 64}
F32_TOL = 1e-5


class BatchesInput(Input):
    """Hands out the given batches, then ends."""

    def __init__(self, batches):
        self.batches = list(batches)

    async def connect(self) -> None:
        return None

    async def read(self):
        if not self.batches:
            raise EndOfInput()
        return self.batches.pop(0), NoopAck()


def _tensor_stream(model: str, model_config: dict, field: str, buckets, outputs, **extra):
    return {"input": {"type": "generate", "payload": "x", "batch_size": 1, "count": 1},
            "pipeline": {"thread_num": 1, "processors": [{
                "type": "gpu_inference", "model": model, "model_config": model_config,
                "tensor_field": field, "batch_buckets": buckets, "outputs": outputs,
                "device": "cpu", **extra}]},
            "output": {"type": "drop"}}


def _run(cfg: dict, batches, host=None):
    stream = build_stream(StreamConfig.from_mapping(cfg))
    proc = stream.pipeline.processors[0]
    if host is not None:
        p = cfg["pipeline"]["processors"][0]
        proc.runner = ModelRunner(p["model"], p["model_config"], buckets=proc.runner.buckets,
                                  device="cpu", host_params=params_from_jax(host))
    stream.input = BatchesInput(batches)
    sink = stream.output = Collect()
    asyncio.run(stream.run(asyncio.Event()))
    assert stream.errors == 0
    return proc, sink


# -- extract_tensor ---------------------------------------------------------

BINARY_CASES = {
    "uniform": [bytes(range(12))] * 3,
    "uniform_short": [b"abcd"] * 3,
    "uniform_long": [bytes(range(40))] * 2,
    "ragged_gather": [b"a", b"", b"abcdefghijklmnop", b"xyz"],
    "ragged_slices": [bytes(range(200)) * 3, b"q", bytes(range(256)) * 2],
    "truncated": [b"0123456789abcdefXYZ", b"short"],
}


@pytest.mark.parametrize("case", sorted(BINARY_CASES))
@pytest.mark.parametrize("dtype,want", [("float32", (4, 3)), ("int32", (12,)), ("uint8", (2, 2, 3))])
def test_extract_binary_equals_jax(case, dtype, want):
    payloads = BINARY_CASES[case]
    exp = jax_extract_tensor(JaxBatch.new_binary(payloads), "__value__", "x", dtype, want,
                             who="t")
    got = extract_tensor(MessageBatch.new_binary(payloads), "__value__", "x", dtype, want,
                         who="t")
    assert got.dtype == exp.dtype and got.shape == exp.shape == (len(payloads), *want)
    np.testing.assert_array_equal(got, exp)


def test_extract_reads_a_sliced_binary_column():
    payloads = [bytes([i]) * (i % 5 + 1) for i in range(9)]
    part = MessageBatch.new_binary(payloads).slice(3, 4)
    got = extract_tensor(part, "__value__", "x", "uint8", (5,), who="t")
    exp = jax_extract_tensor(JaxBatch.new_binary(payloads[3:7]), "__value__", "x", "uint8", (5,),
                             who="t")
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("want", [(6,), (2, 3), (3, 1, 2)])
def test_extract_fixed_size_columns_equal_jax(want):
    """The port's fixed-size list is a 2-D numpy column."""
    flat = np.arange(24, dtype=np.float64).reshape(4, 6) / 3
    jb = JaxBatch.new_binary([b""] * 4).with_column(
        "w", pa.FixedSizeListArray.from_arrays(pa.array(flat.reshape(-1)), 6))
    tb = MessageBatch.new_binary([b""] * 4).with_column("w", flat)
    exp = jax_extract_tensor(jb, "w", "values", "float32", want, who="t")
    got = extract_tensor(tb, "w", "values", "float32", want, who="t")
    assert got.dtype == exp.dtype == np.float32
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("want", [(), (1,), (1, 1)])
def test_extract_scalar_columns_equal_jax(want):
    vals = np.array([1.5, -2.0, 3.25])
    jb = JaxBatch.from_pydict({"s": vals.tolist()})
    tb = MessageBatch({"s": vals})
    exp = jax_extract_tensor(jb, "s", "x", "float32", want, who="t")
    got = extract_tensor(tb, "s", "x", "float32", want, who="t")
    np.testing.assert_array_equal(got, exp)


def test_extract_errors_are_jax_errors():
    tb = MessageBatch.new_binary([b"a", b"b"]).with_column("s", np.array([1.0, 2.0])) \
        .with_column("w", np.zeros((2, 5)))
    jb = JaxBatch.new_binary([b"a", b"b"]).with_column("s", pa.array([1.0, 2.0])).with_column(
        "w", pa.FixedSizeListArray.from_arrays(pa.array(np.zeros(10)), 5))
    for field, want in (("missing", (2,)), ("s", (2,)), ("w", (3,))):
        with pytest.raises(JaxProcessError) as jerr:
            jax_extract_tensor(jb, field, "x", "float32", want, who="t")
        with pytest.raises(ProcessError) as terr:
            extract_tensor(tb, field, "x", "float32", want, who="t")
        # the message up to numpy's own reshape wording
        assert str(terr.value).split(": cannot")[0] == str(jerr.value).split(": cannot")[0]


def test_ragged_list_columns_are_not_yet_ported():
    """Kept by name from when a ragged list column raised "not yet ported":
    the json codec's list columns now take JAX's path, flattened fully and
    reshaped per row. A ragged column whose values do not fill ``want``
    raises JAX's reshape error; one whose values do reshapes as JAX's."""
    short = {"w": [[1.0, 2.0], [3.0]]}
    with pytest.raises(JaxProcessError, match="does not reshape"):
        jax_extract_tensor(JaxBatch.from_pydict(short), "w", "x", "float32", (2,), who="t")
    with pytest.raises(ProcessError, match="does not reshape"):
        extract_tensor(MessageBatch.from_pydict(short), "w", "x", "float32", (2,), who="t")
    ragged = {"w": [[1.0, 2.0, 3.0], [4.0], None, [5.0, 6.0, 7.0, 8.0]]}
    want = jax_extract_tensor(JaxBatch.from_pydict(ragged), "w", "x", "float32", (2,), who="t")
    with pytest.raises(ProcessError, match="does not reshape"):
        extract_tensor(MessageBatch.from_pydict(ragged), "w", "x", "float32", (3,), who="t")
    got = extract_tensor(MessageBatch.from_pydict(ragged), "w", "x", "float32", (2,), who="t")
    assert got.dtype == want.dtype and np.array_equal(got, want)


# -- the tensor families through gpu_inference -------------------------------


def test_e2e_lstm_ae_tensor_field():
    """Sensor windows as a fixed-size column -> LSTM-AE anomaly scores: the
    outlier window scores highest, and every score equals the JAX stream's
    on the same weights (f32, 1e-5); one graph key per batch bucket."""
    window, feats = TINY_LSTM["window"], TINY_LSTM["features"]
    rows = [np.ones((window, feats)) * (10.0 if i == 3 else 0.1) for i in range(6)]
    jcfg = {"input": {"type": "memory", "codec": "json",
                      "messages": [json.dumps({"window": r.reshape(-1).tolist()})
                                   for r in rows]},
            "pipeline": {"thread_num": 1, "processors": [{
                "type": "tpu_inference", "model": "lstm_ae", "model_config": TINY_LSTM,
                "tensor_field": "window", "batch_buckets": [4, 8], "outputs": ["score"]}]},
            "output": {"type": "drop"}}
    jax_stream = jax_build_stream(JaxStreamConfig.from_mapping(jcfg))
    jax_sink = jax_stream.output = JaxCollectOutput()
    asyncio.run(jax_stream.run(asyncio.Event()))
    want = [v for b in jax_sink.batches for v in b.column("score").to_pylist()]
    host = jax.device_get(jax_stream.pipeline.processors[0].runner.host_params)

    flat = np.stack([r.reshape(-1) for r in rows])
    batch = MessageBatch.new_binary([b""] * 6).with_column("window", flat)
    cfg = _tensor_stream("lstm_ae", TINY_LSTM, "window", [4, 8], ["score"], warmup=True)
    proc, sink = _run(cfg, [batch.slice(0, 2), batch.slice(2, 4)], host)
    scores = np.concatenate([b.column("score") for b in sink.batches])
    assert scores.shape == (6,) and scores.dtype == np.float32
    assert int(np.argmax(scores)) == 3
    np.testing.assert_allclose(scores, np.asarray(want, np.float32), atol=F32_TOL, rtol=F32_TOL)
    assert all(not b.has_column("reconstruction") for b in sink.batches)  # default: rank-1 only
    keys = proc.runner.dispatch_counts()
    assert sorted(dict(k)["values"] for k in keys) == [(4, window, feats)]
    assert proc.runner.captures == 2  # one graph per batch bucket, no seq grid


def test_vit_embedding_output_as_fixed_list():
    """Image bytes -> ViT embeddings attached as a [rows, hidden] column
    (the port's fixed-size list), equal to the JAX stream's on the same
    weights at the bf16 floor."""
    from tests.test_torch_vit import emb_atol

    size = TINY_VIT["image_size"]
    img = bytes(range(256)) * ((size * size * 3) // 256)
    other = bytes(reversed(img))
    jcfg = {"input": {"type": "memory", "messages": [img, other]},
            "pipeline": {"thread_num": 1, "processors": [{
                "type": "tpu_inference", "model": "vit_embedder", "model_config": TINY_VIT,
                "tensor_field": "__value__", "batch_buckets": [2], "outputs": ["embedding"]}]},
            "output": {"type": "drop"}}
    jax_stream = jax_build_stream(JaxStreamConfig.from_mapping(jcfg))
    jax_sink = jax_stream.output = JaxCollectOutput()
    asyncio.run(jax_stream.run(asyncio.Event()))
    want = np.concatenate([np.asarray(b.column("embedding").flatten()).reshape(-1, 32)
                           for b in jax_sink.batches])
    host = jax.device_get(jax_stream.pipeline.processors[0].runner.host_params)

    cfg = _tensor_stream("vit_embedder", TINY_VIT, "__value__", [2], ["embedding"])
    _, sink = _run(cfg, [MessageBatch.new_binary([img, other])], host)
    cols = [b.column("embedding") for b in sink.batches]
    assert all(c.ndim == 2 and c.shape[1] == 32 and c.dtype == np.float32 for c in cols)
    got = np.concatenate(cols)
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got, want, atol=emb_atol(want), rtol=0)


@pytest.mark.parametrize("model,mc", [("vit_embedder", TINY_VIT), ("lstm_ae", TINY_LSTM)])
def test_lifecycle_keys_on_a_tensor_stream(tmp_path, model, mc):
    """checkpoint, step_deadline, health, swap and integrity on a tensor
    family: rows delivered and probed; the default canary refuses a seed-1
    swap (its argmax signature differs), as JAX's does; with agreement
    waived it swaps and serves the new weights."""
    fam = get_model(model)
    cfg = fam.make_config(**mc)
    for seed in (0, 1):
        checkpoint.save(str(tmp_path / f"c{seed}"), fam.init(torch.Generator().manual_seed(seed),
                                                             cfg))
    scfg = _tensor_stream(model, mc, "__value__", [2, 4], None, warmup=True,
                          checkpoint=str(tmp_path / "c0"), step_deadline="5s",
                          health={"probe_backoff": "10ms"}, swap={},
                          integrity={"probe_interval": "10ms", "digest_every": 1})
    payloads = [bytes([i * 7 % 256]) * (50 + 13 * i) for i in range(7)]
    proc, sink = _run(scfg, [MessageBatch.new_binary(payloads[:3]),
                             MessageBatch.new_binary(payloads[3:])])
    assert sum(b.num_rows for b in sink.batches) == 7
    assert proc.integrity.report()["results"]["error"] == 0
    assert proc.runner.health.state == "healthy"

    async def swaps():
        with pytest.raises(Exception, match="rolled back at canary"):
            await proc.swapper.swap(str(tmp_path / "c1"))
        proc.swapper.cfg = dataclasses.replace(proc.swapper.cfg, min_agreement=0.0)
        return await proc.swapper.swap(str(tmp_path / "c1"))

    rep = asyncio.run(swaps())
    assert rep["version"] == 1
    batch = MessageBatch.new_binary(payloads[:2])
    inputs = proc._extract(batch)
    got = proc.runner.infer_sync(inputs)
    want = fam.apply(fam.init(torch.Generator().manual_seed(1), cfg), cfg,
                     **{k: torch.from_numpy(v) for k, v in inputs.items()})
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].numpy())


@pytest.mark.parametrize("name", sorted(FAMILY_CONFIGS))
def test_golden_reference_tie_free_for_every_family(name):
    """Both packages register the same four families, and the integrity
    plane's seed search succeeds for every one, on JAX's weights, with
    JAX's golden inputs; the signature is the port forward's argmax and
    equals JAX's."""
    assert list_models() == jax_list_models() == sorted(FAMILY_CONFIGS)
    jfam, tfam = jax_get_model(name), get_model(name)
    jcfg, tcfg = jfam.make_config(**FAMILY_CONFIGS[name]), tfam.make_config(**FAMILY_CONFIGS[name])
    host = jax.device_get(jfam.init(jax.random.PRNGKey(0), jcfg))
    tp = params_from_jax(host)
    ref = find_golden_reference(tfam, tcfg, tp, rows=2, seq=8, seed=0x90D, serving_dtype=None)
    jref = jax_find_golden(jfam, jcfg, host, rows=2, seq=8, seed=0x90D, serving_dtype=None)
    assert ref.margin >= MARGIN_FLOOR[None]
    for k in ref.inputs:
        np.testing.assert_array_equal(ref.inputs[k], np.asarray(jref.inputs[k]))
    out = tfam.apply(tp, tcfg, **{k: torch.from_numpy(v) for k, v in ref.inputs.items()})
    np.testing.assert_array_equal(ref.signature, argmax_signature(
        {k: v.float().numpy() for k, v in out.items()}))
    if ref.seed == jref.seed:
        np.testing.assert_array_equal(ref.signature, np.asarray(jref.signature))


# -- the embedding lookup clamps as JAX's does --------------------------------


def test_bert_clamps_out_of_range_ids_as_jax():
    jfam, tfam = jax_get_model("bert_classifier"), get_model("bert_classifier")
    jcfg, tcfg = jfam.make_config(**TINY_BERT), tfam.make_config(**TINY_BERT)
    host = jax.device_get(jfam.init(jax.random.PRNGKey(0), jcfg))
    v = TINY_BERT["vocab_size"]
    ids = np.array([[1, v - 1, v, v + 7, 2 ** 20, 5, 0, 0]] * 2, np.int32)
    mask = (ids > 0).astype(np.int32)
    # on device arrays, as JAX serves (a numpy table would raise)
    want = jfam.apply(jax.tree_util.tree_map(jnp.asarray, host), jcfg,
                      input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    tp = params_from_jax(host)
    got = tfam.apply(tp, tcfg, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1 / 64, rtol=0)
    clamped = tfam.apply(tp, tcfg, input_ids=torch.from_numpy(np.minimum(ids, v - 1)),
                         attention_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got["logits"].numpy(), clamped["logits"].numpy())


def test_decoder_clamps_out_of_range_ids_in_every_path():
    """forward against JAX's; the paged server (prefill, chunk, decode) and
    the batch generator on ids past the vocabulary give what they give on
    the clamped ids."""
    from arkflow_tpu_torch.models import decoder as dec
    from arkflow_tpu_torch.tpu.batch_generate import BatchGenerator
    from arkflow_tpu_torch.tpu.serving import GenerationServer

    tiny = dict(vocab_size=32, dim=16, layers=1, heads=2, kv_heads=1, ffn=24, max_seq=64)
    jfam, tfam = jax_get_model("decoder_lm"), get_model("decoder_lm")
    jcfg, tcfg = jfam.make_config(**tiny), tfam.make_config(**tiny)
    host = jax.device_get(jfam.init(jax.random.PRNGKey(0), jcfg))
    ids = np.array([[3, 31, 32, 40, 1000, 7]], np.int32)
    want = np.asarray(jfam.extras["forward"](jax.tree_util.tree_map(jnp.asarray, host), jcfg,
                                             jnp.asarray(ids)))
    tp = params_from_jax(host)
    got = tfam.extras["forward"](tp, tcfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1 / 64, rtol=0)

    prompt, clamped = ids[0].tolist(), np.minimum(ids[0], 31).tolist()
    outs = []
    for p in (prompt, clamped):
        server = GenerationServer(tp, tcfg, slots=2, page_size=4, max_seq=32,
                                  prompt_buckets=[8], prefill_chunk=4)
        gen = BatchGenerator(tp, tcfg, max_new_tokens=4, eos_id=-1)
        row = np.zeros((1, 8), np.int32)
        row[0, :len(p)] = p
        tokens, counts, _ = gen.generate(row, np.array([len(p)], np.int32), 1, dec.make_key(1))

        async def go(server=server, p=p):
            try:
                return await server.generate(p, max_new_tokens=4)
            finally:
                await server.close()
        outs.append((asyncio.run(go()), tokens[0, :counts[0]].tolist()))
    assert outs[0] == outs[1]


def test_tensor_examples_run_on_the_cpu_at_a_tiny_width():
    """``vit_stream.json`` and ``lstm_stream.json`` as shipped, with a tiny
    model_config and the CPU: every row delivered with its output."""
    from arkflow_tpu_torch.config import EngineConfig
    from arkflow_tpu_torch.runtime.engine import Engine

    root = os.path.join(os.path.dirname(__file__), "..", "arkflow_tpu_torch", "examples")
    for name, mc, out in (("vit_stream.json", TINY_VIT, "embedding"),
                          ("lstm_stream.json", TINY_LSTM, "score")):
        with open(os.path.join(root, name)) as f:
            raw = json.load(f)
        raw["streams"][0]["input"]["count"] = 40
        raw["streams"][0]["pipeline"]["processors"][0].update(model_config=mc, device="cpu")
        engine = Engine(EngineConfig.from_mapping(raw))
        stream = engine.build()[0]
        sink = stream.output = Collect()
        asyncio.run(engine.run())
        assert stream.errors == 0 and sum(b.num_rows for b in sink.batches) == 40
        assert all(b.has_column(out) for b in sink.batches)
