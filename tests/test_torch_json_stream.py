"""The JSON data plane of the port against the JAX package's, on the CPU.

``json_to_arrow`` / ``arrow_to_json``, the ``batch`` processor, the
``codec`` key of ``generate``, ``memory`` and ``stdout``, string text
columns in ``gpu_inference`` / ``gpu_generate`` and the coalescer, and two
streams end to end: TINY_BERT packed behind ``json_to_arrow`` and
``arrow_to_json``, and ``lstm_ae`` fed a JSON ``window`` list, each against
the JAX stream on the same weights (ids and keys exact, labels exact on
tie-free rows, bf16 scores within 1/64, float32 scores within 1e-5).
"""

from __future__ import annotations

import asyncio
import json
import math

import jax
import numpy as np
import pyarrow as pa
import pytest

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.config import StreamConfig as JaxStreamConfig
from arkflow_tpu.errors import ProcessError as JaxProcessError
from arkflow_tpu.runtime import build_stream as jax_build_stream
from arkflow_tpu.tpu.extract import payload_token_estimates as jax_estimates
from arkflow_tpu_torch.batch import MessageBatch, StringColumn
from arkflow_tpu_torch.components import Resource, build_component, ensure_plugins_loaded
from arkflow_tpu_torch.config import EngineConfig, StreamConfig
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError, ProcessError
from arkflow_tpu_torch.runtime import cli
from arkflow_tpu_torch.runtime.stream import build_stream
from arkflow_tpu_torch.tpu.bucketing import MicroBatchCoalescer
from arkflow_tpu_torch.tpu.extract import payload_token_estimates
from arkflow_tpu_torch.tpu.runner import ModelRunner
from tests.test_runtime import CollectOutput as JaxCollect
from tests.test_torch_stream import TINY_DECODER, Collect, _generate_stream
from tests.test_tpu_layer import TINY_BERT

jax_plugins()
ensure_plugins_loaded()

SCORE_TOL = 1.0 / 64
F32_TOL = 1e-5
#: a two-class score above sigmoid(0.05) has a top-2 logit gap above 0.05
TIE_FREE_SCORE = 1.0 / (1.0 + math.exp(-0.05))
TEXTS = ["ok", "sensor reading looks fine", "pressure spike on line four, check valve",
         " ".join(f"token{i}" for i in range(40)), "", "héllo wörld ☃ a b c", "x, y; z!"]


def both_procs(cfg: dict):
    return (jax_build("processor", cfg, JaxResource()),
            build_component("processor", cfg, Resource()))


def run(coro):
    return asyncio.run(coro)


# -- json_to_arrow / arrow_to_json -------------------------------------------


@pytest.mark.parametrize("cfg,payloads", [
    ({"type": "json_to_arrow"}, [b'{"a":1,"s":"x"}', b'{"a":2.5,"l":[1,2]}']),
    ({"type": "json_to_arrow"}, [b'[{"a":1},{"a":2}]']),
    ({"type": "json_to_arrow"}, [b'{"a":1}\n{"a":2}\n{"a":3}']),
    ({"type": "json_to_arrow", "value_field": "body"}, [b'{"t":"2024-01-01"}', b'{"t":"x"}']),
], ids=["reader_route", "array_changes_rows", "ndjson_changes_rows", "value_field"])
def test_json_to_arrow_matches_jax(cfg, payloads):
    jp, pp = both_procs(cfg)
    field = cfg.get("value_field", "__value__")
    jb = JaxBatch.from_pydict({field: pa.array(payloads, pa.binary())}).with_source("kafka:t")
    pb = MessageBatch.new_binary(payloads)
    if field != "__value__":
        pb = MessageBatch({field: pb.column("__value__")})
    pb = pb.with_source("kafka:t")
    [jout], [pout] = run(jp.process(jb)), run(pp.process(pb))
    assert pout.column_names == jout.column_names
    assert pout.schema == {f.name: str(f.type) for f in jout.schema}
    assert pout.to_pydict() == jout.to_pydict()


def test_json_to_arrow_errors_match_jax():
    jp, pp = both_procs({"type": "json_to_arrow"})
    for payloads in ([b'{"a":1}', b'{"a":"x"}'], [b'{"a":']):
        with pytest.raises(JaxProcessError, match="^json_to_arrow: invalid JSON: ") as je:
            run(jp.process(JaxBatch.new_binary(payloads)))
        with pytest.raises(ProcessError, match="^json_to_arrow: invalid JSON: ") as pe:
            run(pp.process(MessageBatch.new_binary(payloads)))
        assert str(pe.value).split(":")[:3] == str(je.value).split(":")[:3]
    with pytest.raises(ProcessError, match="no 'body' column"):
        run(build_component("processor", {"type": "json_to_arrow", "value_field": "body"},
                            Resource()).process(MessageBatch.new_binary([b"{}"])))
    assert run(pp.process(MessageBatch.new_binary([b"", b" "]))) == []


@pytest.mark.parametrize("fields", [None, ["id", "label", "score"], ["score", "id"], ["nope"]],
                         ids=["all", "some", "batch_order", "missing"])
def test_arrow_to_json_matches_jax(fields):
    cfg = {"type": "arrow_to_json", **({"fields": fields} if fields is not None else {})}
    jp, pp = both_procs(cfg)
    rng = np.random.default_rng(1)
    labels, scores = rng.integers(0, 2, 4), rng.random(4).astype(np.float32)
    emb = rng.standard_normal((4, 3)).astype(np.float32)
    jb = (JaxBatch.from_pydict({"id": [1, 2, 3, 4], "text": ["a", None, "ç", ""]})
          .with_column("label", pa.array(labels)).with_column("score", pa.array(scores))
          .with_column("emb", pa.FixedSizeListArray.from_arrays(pa.array(emb.reshape(-1)), 3))
          .with_source("generate"))
    pb = (MessageBatch.from_pydict({"id": [1, 2, 3, 4], "text": ["a", None, "ç", ""]})
          .with_column("label", labels).with_column("score", scores).with_column("emb", emb)
          .with_source("generate"))
    [jout], [pout] = run(jp.process(jb)), run(pp.process(pb))
    assert pout.to_binary() == jout.to_binary()
    assert pout.column_names == jout.column_names == ["__value__", "__meta_source"]
    assert pout.get_meta("__meta_source") == "generate"


# -- the batch processor -------------------------------------------------------


def test_batch_processor_accumulates_like_jax():
    """count 2 over five one-row batches: two emitted pairs, the fifth held
    and dropped at close (``tests/test_runtime.py``)."""
    msgs = [f'{{"i":{i}}}' for i in range(5)]
    raw = {"input": {"type": "memory", "messages": msgs, "codec": "json"},
           "pipeline": {"thread_num": 1, "processors": [{"type": "batch", "count": 2}]},
           "output": {"type": "drop"}}
    jstream = jax_build_stream(JaxStreamConfig.from_mapping(raw))
    jsink = jstream.output = JaxCollect()
    run(jstream.run(asyncio.Event()))
    stream = build_stream(StreamConfig.from_mapping(raw))
    sink = stream.output = Collect()
    run(stream.run(asyncio.Event()))
    assert [b.num_rows for b in sink.batches] == [b.num_rows for b in jsink.batches] == [2, 2]
    assert ([b.to_pydict()["i"] for b in sink.batches]
            == [b.column("i").to_pylist() for b in jsink.batches] == [[0, 1], [2, 3]])


def test_batch_processor_timeout_flush_like_jax():
    """``tests/test_units.py``: below count, the timeout flushes on the next
    batch."""
    async def go(proc, batch_cls):
        out1 = await proc.process(batch_cls.from_pydict({"x": [1]}))
        await asyncio.sleep(0.05)
        out2 = await proc.process(batch_cls.from_pydict({"x": [2]}))
        return out1, out2

    jp, pp = both_procs({"type": "batch", "count": 100, "timeout": "30ms"})
    (j1, j2), (p1, p2) = run(go(jp, JaxBatch)), run(go(pp, MessageBatch))
    assert p1 == j1 == []
    assert [b.to_pydict() for b in p2] == [b.to_pydict() for b in j2] == [{"x": [1, 2]}]


def test_batch_processor_config_like_jax():
    with pytest.raises(ConfigError, match="requires 'count'"):
        build_component("processor", {"type": "batch"}, Resource())
    with pytest.raises(ConfigError, match="must be positive"):
        build_component("processor", {"type": "batch", "count": 0}, Resource())
    with pytest.raises(ConfigError, match="not yet ported"):
        build_component("processor", {"type": "batch", "count": 2, "size": 3}, Resource())


# -- the codec keys ---------------------------------------------------------


def _collect_stream(raw: dict, jax_raw: dict | None = None):
    jstream = jax_build_stream(JaxStreamConfig.from_mapping(jax_raw or raw))
    jsink = jstream.output = JaxCollect()
    run(asyncio.wait_for(jstream.run(asyncio.Event()), timeout=20))
    stream = build_stream(StreamConfig.from_mapping(raw))
    sink = stream.output = Collect()
    run(asyncio.wait_for(stream.run(asyncio.Event()), timeout=20))
    want = [r for b in jsink.batches for r in b.strip_metadata().record_batch.to_pylist()]
    got = [r for b in sink.batches for r in b.strip_metadata().to_pylist()]
    return got, want, stream


def test_generate_codec_decodes_the_template_once_like_jax(monkeypatch):
    from arkflow_tpu_torch.plugins.codec.json_codec import JsonCodec

    calls = []
    orig = JsonCodec.decode_many
    monkeypatch.setattr(JsonCodec, "decode_many",
                        lambda self, p: calls.append(len(p)) or orig(self, p))
    raw = {"input": {"type": "generate", "codec": "json", "batch_size": 3, "count": 8,
                     "payloads": [{"id": 1, "v": 0.5}, {"id": 2, "v": 1}, {"id": 3, "v": None}]},
           "output": {"type": "drop"}}
    got, want, stream = _collect_stream(raw)
    assert got == want and len(got) == 8
    assert calls == [3]  # one decode of the template's three rows


def test_memory_codec_decodes_each_message_like_jax():
    msgs = ['{"a":1}', '[{"a":2},{"a":3}]', '{"a":4}\n{"a":5}', "  ", {"a": 6}]
    raw = {"input": {"type": "memory", "codec": "json", "messages": msgs},
           "output": {"type": "drop"}}
    got, want, _ = _collect_stream(raw)
    assert got == want == [{"a": i} for i in range(1, 7)]


@pytest.mark.parametrize("codec", [None, "json", {"type": "json"}], ids=["none", "json", "map"])
def test_stdout_codec_writes_like_jax(codec):
    lines: dict = {"jax": [], "port": []}
    cfg = {"type": "stdout", **({"codec": codec} if codec else {})}
    jout = jax_build("output", cfg, JaxResource())
    pout = build_component("output", cfg, Resource())
    jout._write, pout._write = lines["jax"].append, lines["port"].append
    data = {"id": [1, 2], "s": ["a", None], "f": [0.5, 1.5]}
    run(jout.write(JaxBatch.from_pydict(data).with_source("m")))
    run(pout.write(MessageBatch.from_pydict(data).with_source("m")))
    run(jout.write(JaxBatch.new_binary([b"raw 1", b"raw 2"]).with_source("m")))
    run(pout.write(MessageBatch.new_binary([b"raw 1", b"raw 2"]).with_source("m")))
    assert lines["port"] == lines["jax"]


def test_codec_keys_validate_and_unknown_codecs_raise(tmp_path):
    stream = {"input": {"type": "memory", "messages": ['{"a":1}'], "codec": "json"},
              "output": {"type": "stdout", "codec": "json"}}
    assert EngineConfig.from_mapping({"streams": [stream]}).validate_components() == []
    stream["input"]["codec"] = "avro"
    problems = EngineConfig.from_mapping({"streams": [stream]}).validate_components()
    assert len(problems) == 1 and "unknown codec type 'avro'" in problems[0]
    stream["input"]["codec"] = {"type": "json", "pretty": True}
    problems = EngineConfig.from_mapping({"streams": [stream]}).validate_components()
    assert len(problems) == 1 and "not yet ported" in problems[0]
    path = tmp_path / "s.json"
    path.write_text(json.dumps({"streams": [stream]}))
    assert cli.main(["--config", str(path), "--validate"]) == 2


# -- string text columns (the repair this slice makes reachable) -------------


def test_coalescer_estimates_read_string_columns_like_jax():
    col = StringColumn.from_pylist(TEXTS + [None])
    arr = pa.array(TEXTS + [None], pa.string())
    for kw in ({}, {"token_bytes": 4.0}, {"max_tokens": 6}):
        np.testing.assert_array_equal(payload_token_estimates(col, **kw),
                                      jax_estimates(arr, **kw))
    co = MicroBatchCoalescer([8], token_budget=64, token_field="text", max_row_tokens=32)
    batch = MessageBatch.from_pydict({"text": TEXTS})
    np.testing.assert_array_equal(co._row_tokens(batch), jax_estimates(pa.array(TEXTS),
                                                                        max_tokens=32))


def _bert_proc(kind: str, **extra) -> dict:
    proc = {"type": kind, "model": "bert_classifier", "model_config": TINY_BERT,
            "max_seq": 32, "batch_buckets": [2, 4, 8], "seq_buckets": [16, 32],
            "text_field": "text", "outputs": ["label", "score", "logits"], **extra}
    if kind == "gpu_inference":
        proc["device"] = "cpu"
    return proc


@pytest.mark.parametrize("packing", [False, True], ids=["padded", "packed"])
def test_gpu_inference_reads_a_string_text_column_like_jax(packing):
    jproc = jax_build("processor", _bert_proc("tpu_inference", packing=packing), JaxResource())
    host = params_from_jax(jax.device_get(jproc.runner.host_params))
    pproc = build_component("processor", _bert_proc("gpu_inference", packing=packing), Resource())
    pproc.runner = ModelRunner("bert_classifier", TINY_BERT, buckets=pproc.runner.buckets,
                               device="cpu", host_params=host, packed=packing)
    texts = TEXTS + [None]
    [jout] = run(jproc.process(JaxBatch.from_pydict({"text": texts})))
    [pout] = run(pproc.process(MessageBatch.from_pydict({"text": texts})))
    want = np.asarray(jout.column("logits").flatten()).reshape(-1, 2)
    np.testing.assert_allclose(pout.column("logits"), want, atol=SCORE_TOL, rtol=0)
    tie_free = np.abs(want[:, 0] - want[:, 1]) > 0.05
    np.testing.assert_array_equal(pout.column("label")[tie_free],
                                  np.asarray(jout.column("label"))[tie_free])
    with pytest.raises(ProcessError, match="not a binary column or a string column"):
        run(pproc.process(MessageBatch.from_pydict({"text": [1, 2]})))


def test_gpu_generate_reads_a_string_text_column_like_jax():
    from arkflow_tpu_torch.models import get_model
    from arkflow_tpu_torch.tpu.serving import GenerationServer

    def cfg(kind):
        raw = _generate_stream(kind)
        raw["input"]["payloads"] = [{"id": i, "prompt": t} for i, t in enumerate(
            ["sensor alpha", " ".join(f"w{i}" for i in range(20)), "x", "pressure spike"])]
        raw["input"]["codec"] = "json"
        raw["pipeline"]["processors"][0]["text_field"] = "prompt"
        return raw

    jstream = jax_build_stream(JaxStreamConfig.from_mapping(cfg("tpu_generate")))
    jsink = jstream.output = JaxCollect()
    run(jstream.run(asyncio.Event()))
    host = params_from_jax(jax.device_get(jstream.pipeline.processors[0].params))
    stream = build_stream(StreamConfig.from_mapping(cfg("gpu_generate")))
    proc = stream.pipeline.processors[0]
    old = proc.server
    proc.server = GenerationServer(
        host, get_model("decoder_lm").make_config(**TINY_DECODER), slots=2, page_size=4,
        max_seq=old.max_seq, prompt_buckets=old.prompt_buckets, prefill_chunk=8,
        dispatch_depth=2)
    sink = stream.output = Collect()
    run(stream.run(asyncio.Event()))
    want = [t for b in jsink.batches for t in b.column("generated").to_pylist()]
    got = [t.decode() for b in sink.batches for t in b.column("generated").to_pylist()]
    assert got == want and len(got) == 7
    assert ([i for b in sink.batches for i in b.to_pydict()["id"]]
            == [i for b in jsink.batches for i in b.column("id").to_pylist()])


# -- streams end to end ---------------------------------------------------------


def _json_bert_stream(kind: str, count: int = 61) -> dict:
    """generate(JSON rows) -> memory buffer (token budget) ->
    json_to_arrow -> {gpu,tpu}_inference(packing, text_field text) ->
    arrow_to_json(id, label, score)."""
    rows = [{"id": i, "text": t} for i, t in enumerate(TEXTS)]
    proc = _bert_proc(kind, packing=True, outputs=["label", "score"])
    return {"name": "json_bert",
            "input": {"type": "generate", "payloads": rows, "batch_size": 9, "count": count},
            "buffer": {"type": "memory", "capacity": 8, "timeout": "5ms",
                       "coalesce": {"batch_buckets": [8], "deadline": "50ms",
                                    "token_budget": 8 * 32 - 2 * 32, "max_row_tokens": 32}},
            "pipeline": {"thread_num": 2, "processors": [
                {"type": "json_to_arrow"}, proc,
                {"type": "arrow_to_json", "fields": ["id", "label", "score"]}]},
            "output": {"type": "drop"}}


def test_json_bert_stream_matches_the_jax_stream():
    jstream = jax_build_stream(JaxStreamConfig.from_mapping(_json_bert_stream("tpu_inference")))
    jsink = jstream.output = JaxCollect()
    run(jstream.run(asyncio.Event()))
    host = jax.device_get(jstream.pipeline.processors[1].runner.host_params)
    stream = build_stream(StreamConfig.from_mapping(_json_bert_stream("gpu_inference")))
    proc = stream.pipeline.processors[1]
    proc.runner = ModelRunner("bert_classifier", TINY_BERT, buckets=proc.runner.buckets,
                              device="cpu", host_params=params_from_jax(host), packed=True)
    sink = stream.output = Collect()
    run(stream.run(asyncio.Event()))
    want = [json.loads(p) for b in jsink.batches for p in b.to_binary()]
    got = [json.loads(p) for b in sink.batches for p in b.to_binary()]
    assert [list(r) for r in got] == [list(r) for r in want] == [["id", "label", "score"]] * 61
    assert [r["id"] for r in got] == [r["id"] for r in want] == [
        i % 7 for n in (9,) * 6 + (7,) for i in range(n)]
    scores = np.array([r["score"] for r in want])
    np.testing.assert_allclose([r["score"] for r in got], scores, atol=SCORE_TOL, rtol=0)
    tie_free = scores > TIE_FREE_SCORE
    assert tie_free.sum() >= 30
    assert ([r["label"] for r, t in zip(got, tie_free) if t]
            == [r["label"] for r, t in zip(want, tie_free) if t])
    assert stream.errors == 0 and proc.runner.packed_steps > 0


def test_lstm_behind_the_json_codec_matches_the_jax_stream():
    """memory(codec: json, a ``window`` list a message) -> memory buffer ->
    gpu_inference(lstm_ae, tensor_field window) -> arrow_to_json(score)."""
    from tests.test_torch_tensor_stream import TINY_LSTM

    window, feats = TINY_LSTM["window"], TINY_LSTM["features"]
    rng = np.random.default_rng(4)
    rows = rng.random((10, window * feats)).astype(np.float32)
    rows[6] *= 40.0
    flat = [json.dumps({"window": r.tolist()}) for r in rows]
    nested = [json.dumps({"window": r.reshape(window, feats).tolist()}) for r in rows]

    def cfg(kind):
        proc = {"type": kind, "model": "lstm_ae", "model_config": TINY_LSTM,
                "tensor_field": "window", "batch_buckets": [4, 8], "outputs": ["score"]}
        if kind == "gpu_inference":
            proc["device"] = "cpu"
        return {"input": {"type": "memory", "codec": "json", "messages": flat},
                "buffer": {"type": "memory", "capacity": 4, "timeout": "20ms"},
                "pipeline": {"thread_num": 1, "processors": [
                    proc, {"type": "arrow_to_json", "fields": ["score"]}]},
                "output": {"type": "drop"}}

    jraw = cfg("tpu_inference")
    jstream = jax_build_stream(JaxStreamConfig.from_mapping(jraw))
    jsink = jstream.output = JaxCollect()
    run(jstream.run(asyncio.Event()))
    host = params_from_jax(jax.device_get(jstream.pipeline.processors[0].runner.host_params))
    for messages in (flat, nested):  # a flat list, and the window as rows
        raw = cfg("gpu_inference")
        raw["input"]["messages"] = messages
        stream = build_stream(StreamConfig.from_mapping(raw))
        proc = stream.pipeline.processors[0]
        proc.runner = ModelRunner("lstm_ae", TINY_LSTM, buckets=proc.runner.buckets,
                                  device="cpu", host_params=host)
        sink = stream.output = Collect()
        run(stream.run(asyncio.Event()))
        want = [json.loads(p) for b in jsink.batches for p in b.to_binary()]
        got = [json.loads(p) for b in sink.batches for p in b.to_binary()]
        assert [list(r) for r in got] == [["score"]] * 10
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                   atol=F32_TOL, rtol=F32_TOL)
        assert int(np.argmax([r["score"] for r in got])) == 6
        assert stream.errors == 0


@pytest.mark.parametrize("example", ["bert_json_stream.json", "bert_window_json_stream.json",
                                     "lstm_stream.json"])
def test_json_examples_validate(example, capsys):
    path = "arkflow_tpu_torch/examples/" + example
    assert cli.main(["--config", path, "--validate"]) == 0
    assert "config OK" in capsys.readouterr().out
    cfg = json.load(open(path))
    assert example.split("_stream")[0] in cfg["streams"][0]["name"] or "lstm" in example
    assert "examples/" in cfg["description"]  # names its JAX source config
