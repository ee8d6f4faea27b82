"""The port's stream end to end on the CPU: ``generate -> gpu_inference ->
sink`` and ``generate -> gpu_generate -> sink`` through the engine, CLI and
stream runtime, held against the JAX ``tpu_inference`` and ``tpu_generate``
streams on the same config and weights."""

import asyncio
import json

import jax
import numpy as np
import pytest

from arkflow_tpu.config import StreamConfig as JaxStreamConfig
from arkflow_tpu.runtime import build_stream as jax_build_stream
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, Output, ensure_plugins_loaded
from arkflow_tpu_torch.config import EngineConfig, StreamConfig
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError, EndOfInput
from arkflow_tpu_torch.runtime import cli
from arkflow_tpu_torch.runtime.stream import build_stream
from arkflow_tpu_torch.tpu.runner import ModelRunner
from tests.test_runtime import CollectOutput as JaxCollectOutput
from tests.test_tpu_layer import TINY_BERT

ensure_plugins_loaded()

LOGIT_ATOL = 1.0 / 64  # the bf16 floor of the parity rules
TIE_MARGIN = 0.05
PAYLOADS = ["ok", "sensor reading looks fine", "pressure spike on line four, check valve",
            " ".join(f"token{i}" for i in range(40)), "a b c d e f g h i j k l m n o p"]


def _processor(**extra) -> dict:
    return {"type": "gpu_inference", "model": "bert_classifier", "model_config": TINY_BERT,
            "max_seq": 32, "batch_buckets": [4, 8], "seq_buckets": [16, 32],
            "outputs": ["label", "score", "logits"], "device": "cpu", **extra}


def _stream(count: int = 23, threads: int = 2, **proc) -> dict:
    return {"name": "s", "input": {"type": "generate", "payloads": PAYLOADS, "batch_size": 8,
                                   "count": count},
            "pipeline": {"thread_num": threads, "processors": [_processor(**proc)]},
            "output": {"type": "drop"}}


class Collect(Output):
    def __init__(self):
        self.batches: list[MessageBatch] = []

    async def connect(self) -> None:
        return None

    async def write(self, batch: MessageBatch) -> None:
        self.batches.append(batch)


class NumberedInput(Input):
    """Distinct numbered payloads in ragged batch sizes, counting acks."""

    def __init__(self, sizes):
        self.sizes = list(sizes)
        self.next = 0
        self.acks = []

    async def connect(self) -> None:
        return None

    async def read(self):
        if not self.sizes:
            raise EndOfInput()
        n = self.sizes.pop(0)
        rows = [f"event {self.next + i} " + "word " * ((self.next + i) % 13) for i in range(n)]
        self.next += n
        outer = self

        class CountAck(Ack):
            async def ack(self) -> None:
                outer.acks.append(n)

        return MessageBatch.new_binary([r.encode() for r in rows]), CountAck()


def test_every_row_arrives_in_order_with_outputs():
    stream = build_stream(StreamConfig.from_mapping(_stream(threads=3)))
    stream.input = NumberedInput([5, 8, 1, 8, 3, 7, 8, 2])
    sink = stream.output = Collect()
    asyncio.run(stream.run(asyncio.Event()))
    rows = [p for b in sink.batches for p in b.to_binary()]
    assert [int(r.split()[1]) for r in rows] == list(range(42))
    assert sorted(stream.input.acks) == sorted([5, 8, 1, 8, 3, 7, 8, 2])
    for b in sink.batches:
        assert b.column("label").shape == (b.num_rows,)
        assert set(b.column("label").tolist()) <= {0, 1}
        assert ((b.column("score") >= 0.5) & (b.column("score") <= 1)).all()
        assert b.column("logits").shape == (b.num_rows, 2)
    assert stream.rows_out == 42 and stream.errors == 0 and stream.traffic_seconds > 0


def test_labels_match_the_jax_stream_on_the_same_weights():
    jax_cfg = _stream()
    jax_cfg["pipeline"]["processors"][0] = {**_processor(), "type": "tpu_inference"}
    del jax_cfg["pipeline"]["processors"][0]["device"]
    jax_stream = jax_build_stream(JaxStreamConfig.from_mapping(jax_cfg))
    jax_sink = jax_stream.output = JaxCollectOutput()
    asyncio.run(jax_stream.run(asyncio.Event()))
    host = jax.device_get(jax_stream.pipeline.processors[0].runner.host_params)

    stream = build_stream(StreamConfig.from_mapping(_stream()))
    proc = stream.pipeline.processors[0]
    proc.runner = ModelRunner("bert_classifier", TINY_BERT, buckets=proc.runner.buckets,
                              device="cpu", host_params=params_from_jax(host))
    sink = stream.output = Collect()
    asyncio.run(stream.run(asyncio.Event()))

    want_logits = np.concatenate([
        np.asarray(b.column("logits").flatten()).reshape(-1, 2) for b in jax_sink.batches])
    want_labels = np.concatenate([np.asarray(b.column("label")) for b in jax_sink.batches])
    got_logits = np.concatenate([b.column("logits") for b in sink.batches])
    got_labels = np.concatenate([b.column("label") for b in sink.batches])
    assert got_labels.shape == want_labels.shape == (23,)
    np.testing.assert_allclose(got_logits, want_logits, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want_logits, axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > TIE_MARGIN
    np.testing.assert_array_equal(got_labels[tie_free], want_labels[tie_free])
    got_rows = [p for b in sink.batches for p in b.to_binary()]
    want_rows = [p for b in jax_sink.batches for p in b.to_binary()]
    assert got_rows == want_rows


def _write(tmp_path, cfg: dict, name: str = "stream.json"):
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_runs_and_validates_a_json_config(tmp_path, capsys):
    cfg = {"streams": [{**_stream(count=9), "output": {"type": "stdout"}}],
           "logging": {"level": "warn"}}
    path = _write(tmp_path, cfg)
    assert cli.main(["--config", path, "--validate"]) == 0
    assert "config OK: 1 stream(s)" in capsys.readouterr().out
    assert cli.main(["--config", path]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 9 and lines[:5] == PAYLOADS


def test_toml_config_parses(tmp_path):
    path = tmp_path / "s.toml"
    path.write_text('[[streams]]\n[streams.input]\ntype = "generate"\npayload = "x"\n'
                    '[streams.output]\ntype = "drop"\n')
    cfg = EngineConfig.from_file(path)
    assert cfg.streams[0].input == {"type": "generate", "payload": "x"}
    assert cfg.validate_components() == []


def test_yaml_without_the_module_names_it(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)
    path = tmp_path / "s.yaml"
    path.write_text("streams: []\n")
    with pytest.raises(ConfigError, match="yaml"):
        EngineConfig.from_file(path)


@pytest.mark.parametrize("where,patch", [
    # the stream's temporaries are carried (the 8(b) slice); a key no
    # temporary builder carries still refuses
    ("stream", {"temporary": [{"name": "t", "type": "redis", "ttl": 5}]}),
    ("stream", {"pipeline": {"processors": [], "process_pool": 2}}),
    ("pipeline", {"ingest_shards": 2}),
    ("processor", {"pp_layer_costs": [1.0, 1.0]}),
    ("processor", {"device_pool": 2}),
    ("processor", {"mesh": {"tp": 2}}),
    ("processor", {"pp_microbatch_rows": 4}),
    # the generate input carries every key JAX's reads (``context`` since
    # the SQL slice); a patch with a ``type`` replaces the input: the kafka
    # input's ``pause_on_overload`` is one JAX reads and the port does not
    ("input", {"type": "kafka", "brokers": "b:1", "topic": "t", "group": "g",
               "pause_on_overload": True}),
    # the engine's own keys are all ported (``tracing``, ``profiling_dir``:
    # test_tracing_and_profiling_dir_are_accepted); an unported key inside
    # its streams list still refuses the whole engine config
    ("engine", {"streams": [{"input": {"type": "generate", "payload": "x", "count": 1},
                             "pipeline": {"processors": [], "ingest_shards": 2},
                             "output": {"type": "drop"}}]}),
    ("stream", {"buffer": {"type": "memory", "capacity": 8,
                           "coalesce": {"batch_buckets": [8], "deadline": "5ms", "dp": 2}}}),
])
def test_unported_keys_raise(tmp_path, where, patch):
    stream = _stream(count=4)
    cfg = {"streams": [stream], "health_check": {"enabled": False}}
    target = {"stream": stream, "pipeline": stream["pipeline"], "engine": cfg,
              "processor": stream["pipeline"]["processors"][0], "input": stream["input"]}[where]
    if "type" in patch:
        target.clear()
    target.update(patch)
    with pytest.raises(ConfigError, match="not yet ported"):
        parsed = EngineConfig.from_mapping(cfg)
        problems = parsed.validate_components()
        if problems:
            raise ConfigError("; ".join(problems))
        build_stream(parsed.streams[0])
    assert cli.main(["--config", _write(tmp_path, cfg), "--validate"]) == 2


def test_tracing_and_profiling_dir_are_accepted(tmp_path, monkeypatch):
    """The engine's ``tracing`` block and ``health_check.profiling_dir`` parse
    as the JAX package's do, at ``--validate`` too."""
    from arkflow_tpu_torch.obs.trace import TracingConfig

    monkeypatch.delenv("ARKFLOW_TRACE", raising=False)
    cfg = {"streams": [_stream(count=4)], "tracing": {"sample_rate": 0.25, "slow_n": 4},
           "health_check": {"enabled": True, "profiling_dir": str(tmp_path / "prof")}}
    parsed = EngineConfig.from_mapping(cfg)
    assert parsed.tracing == TracingConfig(sample_rate=0.25, slow_n=4)
    assert parsed.health_check.profiling_dir == str(tmp_path / "prof")
    assert EngineConfig.from_mapping({"streams": [_stream(count=4)]}).tracing == TracingConfig()
    assert cli.main(["--config", _write(tmp_path, cfg), "--validate"]) == 0
    with pytest.raises(ConfigError, match="tracing.sample_rate must be a number in"):
        EngineConfig.from_mapping({**cfg, "tracing": {"sample_rate": 2}})


TINY_DECODER = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, ffn=96, max_seq=64)
GEN_TEXTS = ["sensor alpha", " ".join(f"w{i}" for i in range(20)), "x",
             "pressure spike on line four"]


def _generate_stream(kind: str, **extra) -> dict:
    """generate -> {gpu,tpu}_generate(continuous, TINY decoder) -> drop; the
    20-word text is longer than the prefill chunk of 8. Each batch takes the
    texts from the first, so the fourth is never sent."""
    proc = {"type": kind, "model": "decoder_lm", "model_config": TINY_DECODER,
            "serving": "continuous", "slots": 2, "page_size": 4, "max_input": 24,
            "max_new_tokens": 5, "seq_buckets": [8, 24], "prefill_chunk": 8,
            "dispatch_depth": 2, **extra}
    if kind == "gpu_generate":
        proc["device"] = "cpu"
    return {"name": "gen",
            "input": {"type": "generate", "payloads": GEN_TEXTS, "batch_size": 3, "count": 7},
            "pipeline": {"thread_num": 2, "processors": [proc]},
            "output": {"type": "drop"}}


def test_generate_stream_matches_the_jax_generate_stream():
    """generate -> gpu_generate(continuous) on the CPU against the JAX
    engine's tpu_generate continuous stream on the same texts and weights:
    the same rows in the same order, each with the same generated ids."""
    from arkflow_tpu_torch.models import get_model
    from arkflow_tpu_torch.tpu.serving import GenerationServer

    jax_stream = jax_build_stream(JaxStreamConfig.from_mapping(_generate_stream("tpu_generate")))
    jax_sink = jax_stream.output = JaxCollectOutput()
    asyncio.run(jax_stream.run(asyncio.Event()))
    jproc = jax_stream.pipeline.processors[0]
    host = params_from_jax(jax.device_get(jproc.params))

    stream = build_stream(StreamConfig.from_mapping(_generate_stream("gpu_generate")))
    proc = stream.pipeline.processors[0]
    old = proc.server
    proc.server = GenerationServer(
        host, get_model("decoder_lm").make_config(**TINY_DECODER), slots=2, page_size=4,
        max_seq=old.max_seq, prompt_buckets=old.prompt_buckets, prefill_chunk=8,
        dispatch_depth=2)
    sink = stream.output = Collect()
    asyncio.run(stream.run(asyncio.Event()))

    got_rows = [p for b in sink.batches for p in b.to_binary()]
    assert got_rows == [p for b in jax_sink.batches for p in b.to_binary()]
    assert got_rows == [GEN_TEXTS[i % 4].encode() for n in (3, 3, 1) for i in range(n)]
    want = [t for b in jax_sink.batches for t in b.column("generated").to_pylist()]
    got = [t.decode() for b in sink.batches for t in b.column("generated").to_pylist()]
    assert got == want and all(len(t.split()) <= 5 for t in got)
    assert proc.server.chunk_steps > 0 and proc.server.decode_steps > 0
    assert proc.tokens == sum(len(t.split()) for t in got) > 0
    assert stream.errors == 0 and stream.rows_out == 7


@pytest.mark.parametrize("patch", [{"serving": "batch", "model_config": {**TINY_DECODER,
                                                                         "remat": True}},
                                   {"serving": "batch", "mesh": {"tp": 2}},
                                   {"serving": "batch", "mesh": {"dp": 2}},
                                   {"serving": "batch", "kernel_interpret": True},
                                   {"mesh": {"tp": 2}}, {"kernel_interpret": True},
                                   {"model_config": {**TINY_DECODER, "use_ring_attention": True}},
                                   {"model_config": {**TINY_DECODER, "remat": True}}])
def test_gpu_generate_unported_keys_raise(tmp_path, patch):
    """``mesh``, ``kernel_interpret`` and the decoder's ring attention and
    ``remat`` raise in both serving modes (sampling, ``speculative_tokens``,
    ``prefix_cache_pages``, ``serving: batch``, ``batch_buckets``,
    ``max_batch``, MoE and ``tokenizer`` are ported)."""
    stream = _generate_stream("gpu_generate", **patch)
    cfg = {"streams": [stream]}
    with pytest.raises(ConfigError, match="not yet ported"):
        parsed = EngineConfig.from_mapping(cfg)
        problems = parsed.validate_components()
        if problems:
            raise ConfigError("; ".join(problems))
        build_stream(parsed.streams[0])
    assert cli.main(["--config", _write(tmp_path, cfg), "--validate"]) == 2


@pytest.mark.parametrize("patch", [{"serving": "batch", "batch_buckets": [4],
                                    "model_config": {**TINY_DECODER, "num_experts": 2}},
                                   {"model_config": {**TINY_DECODER, "num_experts": 4}}])
def test_gpu_generate_moe_validates_and_matches_the_jax_stream(tmp_path, patch):
    """MoE in both serving modes (continuous at depth 1: depth 2 refuses
    MoE, as in JAX): ``--validate`` passes, and on the JAX stream's weights
    (copied into the live tree) the port's stream gives the JAX engine's
    rows and generated ids."""
    import torch

    def copy_into(live, new):
        for k, v in new.items():
            copy_into(live[k], v) if isinstance(v, dict) else live[k].copy_(v)

    patch = {**patch, "dispatch_depth": 1}
    cfg = {"streams": [_generate_stream("gpu_generate", **patch)]}
    assert cli.main(["--config", _write(tmp_path, cfg), "--validate"]) == 0
    jax_stream = jax_build_stream(JaxStreamConfig.from_mapping(
        _generate_stream("tpu_generate", **patch)))
    jax_sink = jax_stream.output = JaxCollectOutput()
    asyncio.run(jax_stream.run(asyncio.Event()))
    host = params_from_jax(jax.device_get(jax_stream.pipeline.processors[0].params))

    stream = build_stream(StreamConfig.from_mapping(_generate_stream("gpu_generate", **patch)))
    proc = stream.pipeline.processors[0]
    with torch.no_grad():
        copy_into(proc.params, host)
    sink = stream.output = Collect()
    asyncio.run(stream.run(asyncio.Event()))
    assert "experts" in proc.params["layers"] and stream.errors == 0
    got_rows = [p for b in sink.batches for p in b.to_binary()]
    assert got_rows == [p for b in jax_sink.batches for p in b.to_binary()]
    want = [t for b in jax_sink.batches for t in b.column("generated").to_pylist()]
    got = [t.decode() for b in sink.batches for t in b.column("generated").to_pylist()]
    assert got == want and proc.tokens == sum(len(t.split()) for t in got) > 0


def test_gpu_generate_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream = _generate_stream("gpu_generate")
    del stream["pipeline"]["processors"][0]["device"]
    with pytest.raises(ConfigError, match="no CUDA device"):
        build_stream(StreamConfig.from_mapping(stream))


PACKED_TEXTS = [b"ok", b"sensor reading looks fine", b"pressure spike on line four, check valve",
                b" ".join(b"token%d" % i for i in range(40)), b"", b"a b c d e f g h i j k l",
                b"x, y; z!"]


def _packed_stream(kind: str, count: int = 61) -> dict:
    proc = {"type": kind, "model": "bert_classifier", "model_config": TINY_BERT,
            "max_seq": 32, "batch_buckets": [2, 4, 8], "seq_buckets": [16, 32],
            "packing": True, "outputs": ["label", "score", "logits"]}
    if kind == "gpu_inference":
        proc["device"] = "cpu"
    return {"name": "packed",
            "input": {"type": "generate", "payloads": [t.decode() for t in PACKED_TEXTS],
                      "batch_size": 9, "count": count},
            "buffer": {"type": "memory", "capacity": 8, "timeout": "5ms",
                       "coalesce": {"batch_buckets": [8], "deadline": "50ms",
                                    "token_budget": 8 * 32 - 2 * 32, "max_row_tokens": 32}},
            "pipeline": {"thread_num": 2, "processors": [proc]},
            "output": {"type": "drop"}}


def test_packed_stream_matches_the_jax_packed_stream():
    """generate -> memory buffer (token budget) -> gpu_inference(packing) on
    the CPU against the JAX engine's tpu_inference packed stream on the same
    texts and weights: same rows in the same order, equal tie-free labels,
    logits within the bf16 floor."""
    jax_stream = jax_build_stream(JaxStreamConfig.from_mapping(_packed_stream("tpu_inference")))
    jax_sink = jax_stream.output = JaxCollectOutput()
    asyncio.run(jax_stream.run(asyncio.Event()))
    host = jax.device_get(jax_stream.pipeline.processors[0].runner.host_params)

    stream = build_stream(StreamConfig.from_mapping(_packed_stream("gpu_inference")))
    proc = stream.pipeline.processors[0]
    proc.runner = ModelRunner("bert_classifier", TINY_BERT, buckets=proc.runner.buckets,
                              device="cpu", host_params=params_from_jax(host), packed=True)
    sink = stream.output = Collect()
    asyncio.run(stream.run(asyncio.Event()))

    got_rows = [p for b in sink.batches for p in b.to_binary()]
    assert got_rows == [p for b in jax_sink.batches for p in b.to_binary()]
    assert got_rows == [PACKED_TEXTS[i % 7] for n in (9,) * 6 + (7,) for i in range(n)]
    want_logits = np.concatenate([
        np.asarray(b.column("logits").flatten()).reshape(-1, 2) for b in jax_sink.batches])
    want_labels = np.concatenate([np.asarray(b.column("label")) for b in jax_sink.batches])
    got_logits = np.concatenate([b.column("logits") for b in sink.batches])
    got_labels = np.concatenate([b.column("label") for b in sink.batches])
    np.testing.assert_allclose(got_logits, want_logits, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want_logits, axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > TIE_MARGIN
    assert tie_free.sum() >= 30
    np.testing.assert_array_equal(got_labels[tie_free], want_labels[tie_free])
    assert stream.errors == 0 and proc.runner.packed_steps > 0
    assert proc.runner.packed_steps == proc.runner.device_steps


def test_packed_stream_delivers_every_row_in_order_and_acks_after_write():
    """Ragged source batches split across token-budget emissions: every row
    arrives once and in order, and a source acks only after all its rows
    were written (its split shares all acked)."""
    stream = build_stream(StreamConfig.from_mapping(_packed_stream("gpu_inference")))
    sizes = [5, 8, 1, 8, 3, 7, 8, 2, 11]
    sink = stream.output = Collect()
    inp = stream.input = NumberedInput(sizes)
    written_at_ack = []

    class Recorder(list):
        def append(self, n):  # called by NumberedInput's ack with the batch size
            written_at_ack.append(sum(b.num_rows for b in sink.batches))
            super().append(n)

    inp.acks = Recorder()
    asyncio.run(stream.run(asyncio.Event()))
    rows = [p for b in sink.batches for p in b.to_binary()]
    assert [int(r.split()[1]) for r in rows] == list(range(sum(sizes)))
    assert sorted(inp.acks) == sorted(sizes)
    ends = np.cumsum(sizes)
    # acks fire in source order here (one buffer lane, ordered output)
    assert all(w >= e for w, e in zip(written_at_ack, ends))
    assert stream.rows_out == sum(sizes) and stream.errors == 0
    assert stream.pipeline.processors[0].runner.packed_steps > 0
