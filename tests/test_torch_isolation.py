"""The port stands alone: ``arkflow_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of ``arkflow_tpu``, and no module on the slices'
paths (the padded, the packed and the generate stream, the BERT and
Llama lifecycle streams with their health servers, the Llama serving,
batch and MoE streams, the ViT and LSTM tensor streams, the adaptive
stream with a forced tuner cycle, the chaos and BERT delivery streams, the
packed and windowed JSON BERT streams, the eight broker examples against
the port's fake brokers, and the file and Pulsar examples, whose CSV, NDJSON
and Avro readers and proto2 codec are the port's own) needs pyarrow, yaml, aiohttp, websockets, zstandard
or google.protobuf at import time or at run time. ``transformers`` is imported
only inside ``HFTokenizer``, ``google.protobuf`` only inside the protobuf
codec, ``zstandard`` only inside the zstd codec."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "arkflow_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "arkflow_tpu")
NOT_AT_MODULE_LEVEL = ("pyarrow", "yaml", "aiohttp", "websockets", "transformers", "google",
                       "zstandard")


def _imports(tree: ast.AST, top_level_only: bool):
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree, top_level_only=False) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
    heavy = [m for m in _imports(tree, top_level_only=True) if m in NOT_AT_MODULE_LEVEL]
    assert not heavy, f"{path} imports {heavy} at module level"


_CHILD = r"""
import sys
for name in ("jax", "jaxlib", "arkflow_tpu", "pyarrow", "yaml", "aiohttp", "websockets",
             "google.protobuf"):
    sys.modules[name] = None  # any import of these now fails
import asyncio
from arkflow_tpu_torch.components import ensure_plugins_loaded
from arkflow_tpu_torch.config import StreamConfig
from arkflow_tpu_torch.runtime.stream import build_stream

ensure_plugins_loaded()
tiny = {"vocab_size": 128, "hidden": 16, "layers": 1, "heads": 2, "ffn": 32,
        "max_positions": 32}
cfg = StreamConfig.from_mapping({
    "input": {"type": "generate", "payloads": ["a b c", "d e f g h i j k"],
              "batch_size": 4, "count": 10},
    "pipeline": {"thread_num": 2, "processors": [{
        "type": "gpu_inference", "model": "bert_classifier", "model_config": tiny,
        "max_seq": 16, "batch_buckets": [4], "seq_buckets": [8, 16],
        "device": "cpu", "warmup": True}]},
    "output": {"type": "drop"}})
stream = build_stream(cfg)
asyncio.run(stream.run(asyncio.Event()))
assert stream.output.dropped_rows == 10 and stream.errors == 0, stream.errors
packed = build_stream(StreamConfig.from_mapping({
    "input": {"type": "generate", "payloads": ["a b c", "d e f g h i j k"],
              "batch_size": 4, "count": 10},
    "buffer": {"type": "memory", "capacity": 4, "timeout": "5ms",
               "coalesce": {"batch_buckets": [4], "deadline": "20ms", "token_budget": 32}},
    "pipeline": {"thread_num": 2, "processors": [{
        "type": "gpu_inference", "model": "bert_classifier", "model_config": tiny,
        "max_seq": 16, "batch_buckets": [2, 4], "seq_buckets": [16], "packing": True,
        "device": "cpu"}]},
    "output": {"type": "drop"}}))
asyncio.run(packed.run(asyncio.Event()))
assert packed.output.dropped_rows == 10 and packed.errors == 0, packed.errors
assert packed.pipeline.processors[0].runner.packed_steps > 0
gen = build_stream(StreamConfig.from_mapping({
    "input": {"type": "generate", "payloads": ["a b c", "d e f g h i j k"],
              "batch_size": 2, "count": 3},
    "pipeline": {"thread_num": 2, "processors": [{
        "type": "gpu_generate", "model_config": {"vocab_size": 64, "dim": 16, "layers": 1,
                                                 "heads": 2, "kv_heads": 1, "ffn": 32},
        "serving": "continuous", "slots": 2, "page_size": 4, "max_input": 12,
        "max_new_tokens": 3, "prefill_chunk": 4, "dispatch_depth": 2, "device": "cpu"}]},
    "output": {"type": "drop"}}))
asyncio.run(gen.run(asyncio.Event()))
assert gen.output.dropped_rows == 3 and gen.errors == 0, gen.errors
from arkflow_tpu_torch.config import EngineConfig
from arkflow_tpu_torch.runtime.engine import Engine

life = Engine(EngineConfig.from_mapping({
    "health_check": {"enabled": True, "host": "127.0.0.1", "port": 0},
    "streams": [{"input": {"type": "fault", "redeliver_unacked": True,
                           "inner": {"type": "generate", "payload": "a b c",
                                     "batch_size": 4, "count": 8}},
                 "pipeline": {"thread_num": 1, "processors": [{
                     "type": "fault", "faults": [{"kind": "oom", "at": 1}],
                     "inner": {"type": "gpu_inference", "model": "bert_classifier",
                               "model_config": tiny, "max_seq": 16, "batch_buckets": [2, 4],
                               "seq_buckets": [16], "device": "cpu", "warmup": True,
                               "step_deadline": "5s", "swap": {},
                               "integrity": {"probe_interval": "10ms"}}}]},
                 "output": {"type": "drop"}}]}))
life_stream = life.build()[0]
asyncio.run(life.run())
assert life_stream.output.dropped_rows == 8 and life_stream.errors == 0, life_stream.errors
assert life_stream.pipeline.processors[0].runner.ooms == 1
import json
gen_cfg = json.load(open("arkflow_tpu_torch/examples/llama_lifecycle_stream.json"))
gen_cfg["health_check"]["port"] = 0
gen_inner = gen_cfg["streams"][0]["pipeline"]["processors"][0]["inner"]
gen_inner.update(model_config={"vocab_size": 64, "dim": 16, "layers": 1, "heads": 2,
                               "kv_heads": 1, "ffn": 32}, device="cpu")
gen_inner["integrity"]["probe_interval"] = "200ms"
gen_life = Engine(EngineConfig.from_mapping(gen_cfg))
gen_stream = gen_life.build()[0]
asyncio.run(gen_life.run())
gen_count = gen_cfg["streams"][0]["input"]["inner"]["count"]
assert gen_stream.output.dropped_rows == gen_count and gen_stream.errors >= 2, gen_stream.errors
gen_server = gen_stream.pipeline.processors[0].runner
assert gen_server.core.deadline_misses == 1 and gen_server.health.state == "healthy"
tiny_dec = {"vocab_size": 64, "dim": 16, "layers": 1, "heads": 2, "kv_heads": 1, "ffn": 32}
for example in ("llama_serving_stream.json", "llama_batch_stream.json"):
    ex_cfg = json.load(open("arkflow_tpu_torch/examples/" + example))
    ex_cfg["streams"][0]["pipeline"]["processors"][0].update(model_config=tiny_dec, device="cpu")
    ex_engine = Engine(EngineConfig.from_mapping(ex_cfg))
    ex_stream = ex_engine.build()[0]
    asyncio.run(ex_engine.run())
    ex_count = ex_cfg["streams"][0]["input"]["count"]
    assert ex_stream.output.dropped_rows == ex_count and ex_stream.errors == 0, example
    ex_proc = ex_stream.pipeline.processors[0]
    if ex_proc.server is not None:
        assert ex_proc.server.prefix_hits > 0 and ex_proc.server.verify_steps > 0
    else:
        assert ex_proc.generator.generations >= 3
moe_cfg = json.load(open("arkflow_tpu_torch/examples/llama_moe_stream.json"))
moe_cfg["streams"][0]["input"]["count"] = 12
moe_cfg["streams"][0]["pipeline"]["processors"][0].update(
    model_config={**tiny_dec, "num_experts": 4}, device="cpu", max_new_tokens=4)
moe_engine = Engine(EngineConfig.from_mapping(moe_cfg))
moe_stream = moe_engine.build()[0]
asyncio.run(moe_engine.run())
assert moe_stream.output.dropped_rows == 12 and moe_stream.errors == 0
for example, mc in (("vit_stream.json", {"image_size": 32, "patch": 16, "hidden": 16,
                                         "layers": 1, "heads": 2, "ffn": 32}),
                    ("lstm_stream.json", {"features": 8, "hidden": 8, "latent": 4,
                                          "window": 32})):
    ex_cfg = json.load(open("arkflow_tpu_torch/examples/" + example))
    ex_cfg["streams"][0]["input"]["count"] = 24
    ex_cfg["streams"][0]["pipeline"]["processors"][0].update(model_config=mc, device="cpu")
    ex_engine = Engine(EngineConfig.from_mapping(ex_cfg))
    ex_stream = ex_engine.build()[0]
    asyncio.run(ex_engine.run())
    assert ex_stream.output.dropped_rows == 24 and ex_stream.errors == 0, example
ad_cfg = json.load(open("arkflow_tpu_torch/examples/bert_adaptive_stream.json"))
ad_cfg["health_check"]["port"] = 0
ad_cfg["streams"][0]["input"]["count"] = 64
ad_cfg["streams"][0]["pipeline"]["processors"][0].update(
    model_config={**tiny, "max_positions": 128}, device="cpu")
ad_engine = Engine(EngineConfig.from_mapping(ad_cfg))
ad_stream = ad_engine.build()[0]
asyncio.run(ad_engine.run())
assert ad_stream.output.dropped_rows == 64 and ad_stream.errors == 0, ad_stream.errors
ad_cycle = asyncio.run(ad_stream.tuners()[0].run_cycle(force=True))
assert ad_cycle["action"] in ("committed", "rejected"), ad_cycle
chaos_cfg = json.load(open("arkflow_tpu_torch/examples/chaos_stream.json"))
chaos_cfg["streams"][0]["output"]["inner"] = {"type": "drop"}
chaos_cfg["streams"][0]["error_output"] = {"type": "drop"}
chaos_engine = Engine(EngineConfig.from_mapping(chaos_cfg))
chaos_stream = chaos_engine.build()[0]
asyncio.run(chaos_engine.run())
assert chaos_stream.rows_out == 5 and chaos_stream.quarantined_batches == 1, chaos_stream.errors
assert chaos_stream.output_retries == 3 and chaos_stream._out_breaker.trips == 1
dl_cfg = json.load(open("arkflow_tpu_torch/examples/bert_delivery_stream.json"))
dl_cfg["streams"][0]["pipeline"]["processors"][0]["inner"].update(
    model_config={**tiny, "max_positions": 256}, device="cpu", warmup=False)
dl_engine = Engine(EngineConfig.from_mapping(dl_cfg))
dl_stream = dl_engine.build()[0]
asyncio.run(dl_engine.run())
dl_texts = dl_cfg["streams"][0]["input"]["inner"]["messages"]
assert dl_stream.rows_out == len(dl_texts) - 1 and dl_stream.quarantined_batches == 1
assert dl_stream.reconnects == 1 and dl_stream.input._outstanding == 0
for example in ("bert_json_stream.json", "bert_window_json_stream.json"):
    js_cfg = json.load(open("arkflow_tpu_torch/examples/" + example))
    js = js_cfg["streams"][0]
    js["pipeline"]["processors"][-2].update(
        model_config={**tiny, "max_positions": 256}, device="cpu", warmup=False)
    if js["input"]["type"] == "generate":
        js["input"]["count"] = 40
    assert EngineConfig.from_mapping(js_cfg).validate_components() == [], example
    js_engine = Engine(EngineConfig.from_mapping(js_cfg))
    js_stream = js_engine.build()[0]
    js_rows = []
    js_write = js_stream.output.write

    async def js_capture(batch, _write=js_write):
        js_rows.extend(json.loads(p) for p in batch.to_binary())
        await _write(batch)

    js_stream.output.write = js_capture
    asyncio.run(js_engine.run())
    js_n = js["input"].get("count") or len(js["input"].get("messages", []))
    assert len(js_rows) == js_n and js_stream.errors == 0, example
    assert all(list(r) == ["id", "label", "score"] for r in js_rows), example
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "arkflow_tpu")
          and sys.modules[m] is not None]
assert not leaked, leaked
print("PORT_OK")
"""


_BROKER_CHILD = r"""
import sys
for name in ("jax", "jaxlib", "arkflow_tpu", "pyarrow", "yaml", "aiohttp", "websockets",
             "google.protobuf", "zstandard", "transformers"):
    sys.modules[name] = None  # any import of these now fails
import asyncio
import json

import numpy as np

from arkflow_tpu_torch.tools import broker_streams as bs


def example(name, **proc):
    raw = json.load(open("arkflow_tpu_torch/examples/" + name))
    raw["health_check"] = {"enabled": False}
    raw["streams"][0]["pipeline"]["processors"][0].update(device="cpu", **proc)
    return raw


tiny = {"vocab_size": 128, "hidden": 16, "layers": 1, "heads": 2, "ffn": 32,
        "max_positions": 64}
texts = [f"msg{i} " + "w " * (i % 9) for i in range(24)]
rep = asyncio.run(bs.kafka_to_kafka(
    example("kafka_bert_kafka.json", model_config=tiny, max_seq=32, batch_buckets=[4, 8],
            seq_buckets=[16, 32], warmup=False),
    [t.encode() for t in texts], partitions=4, codecs=["gzip", "snappy", "lz4", None]))
rows = [json.loads(v) for v in rep["values"]]
assert sorted(r["__value__"] for r in rows) == sorted(texts), rows
assert all(list(r) == ["__value__", "label", "score"] for r in rows)
assert rep["keys"] == [str(r["label"]).encode() for r in rows], rep["keys"]
assert rep["committed"] == rep["log_end"] == [6] * 4 and rep["errors"] == 0, rep
assert rep["generation_before"] == rep["generation_after"] == 1, rep
assert rep["input_codecs"] == [0, 1, 2, 3], rep
lstm = {"features": 2, "hidden": 8, "latent": 4, "window": 8}
windows = np.random.default_rng(0).random((20, 16)).round(3)
rep = asyncio.run(bs.mqtt_to_stdout(
    example("mqtt_lstm_anomaly.json", model_config=lstm, batch_buckets=[4, 8]),
    [json.dumps({"window": w.tolist()}).encode() for w in windows], qos=1, window=8))
lines = [json.loads(x) for x in rep["lines"]]
assert len(lines) + rep["filtered"] == 20 and rep["errors"] == 0, rep
assert all(list(r) == ["window", "score", "alert"] and r["score"] > 0.5
           and r["alert"].startswith("anomaly: ") for r in lines), lines
vit = {"image_size": 32, "patch": 16, "hidden": 16, "layers": 1, "heads": 2, "ffn": 32}
raw = example("http_vit_redis.json", model_config=vit, batch_buckets=[4, 8])
raw["streams"][0]["input"]["rate_limit"] = {"capacity": 12, "per_second": 0.01}
images = np.random.default_rng(1).integers(0, 256, (12, 32 * 32 * 3), dtype=np.uint8)
rep = asyncio.run(bs.http_to_redis(raw, [im.tobytes() for im in images], extra=1))
assert rep["statuses"] == [200] * 12 + [429] and rep["connections"] == 1, rep["statuses"]
assert [len(json.loads(v)["embedding"]) for v in rep["values"]] == [16] * 12
dec = {"vocab_size": 64, "dim": 16, "layers": 1, "heads": 2, "kv_heads": 1, "ffn": 32}
rep = asyncio.run(bs.kafka_to_nats(
    example("cdc_llm_nats.json", model_config=dec, max_input=16, max_new_tokens=3,
            seq_buckets=[16]), [f"row {i} changed".encode() for i in range(6)]))
assert [list(json.loads(p)) for p in rep["payloads"]] == [["summary"]] * 6, rep["payloads"]
assert rep["committed"] == rep["log_end"] == 6 and rep["errors"] == 0
rows = [{"id": i, "text": f"msg{i} " + "w " * (i % 9)} for i in range(16)]
raw = example("nats_bert_mqtt.json", model_config=tiny, max_seq=32, batch_buckets=[4, 8],
              seq_buckets=[32], warmup=False)
raw["streams"][0]["input"]["batch_size"] = 8
raw["streams"][0]["buffer"].update(capacity=8)
raw["streams"][0]["buffer"]["coalesce"].update(batch_buckets=[8], token_budget=256,
                                              max_row_tokens=32)
rep = asyncio.run(bs.nats_to_mqtt(raw, [json.dumps(r).encode() for r in rows]))
assert [json.loads(p)["id"] for p in rep["payloads"]] == list(range(16)), rep["payloads"]
assert rep["ack_floor"] == rep["last_seq"] == 16 and rep["errors"] == 0
rep = asyncio.run(bs.redis_to_influx(
    example("redis_lstm_influx.json", model_config=lstm, batch_buckets=[4, 8]),
    [json.dumps({"id": i, "window": w.tolist()}).encode() for i, w in enumerate(windows)],
    statuses=[500]))
assert len(rep["lines"]) == 20 and rep["answered"][:2] == [500, 204], rep["answered"]
rep = asyncio.run(bs.ws_redis_to_http(
    example("ws_redis_bert_http.json", model_config=tiny, max_seq=32, batch_buckets=[4, 8],
            seq_buckets=[16, 32], warmup=False),
    [json.dumps(r) for r in rows[:8]], [json.dumps(r).encode() for r in rows[8:]]))
assert sorted(json.loads(r)["id"] for r in rep["rows"]) == list(range(16)), rep["rows"]
raw = json.load(open("arkflow_tpu_torch/examples/modbus_influx.json"))
raw["streams"][0]["input"]["interval"] = "5ms"
raw["streams"][0]["output"]["flush_interval"] = "50ms"
rep = asyncio.run(bs.modbus_to_influx(raw, 4))
assert len(rep["lines"]) >= 4 and rep["errors"] == 0, rep
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "arkflow_tpu", "transformers")
          and sys.modules[m] is not None]
assert not leaked, leaked
print("BROKERS_OK")
"""


_SQL_CHILD = r"""
import sys
for name in ("jax", "jaxlib", "arkflow_tpu", "pyarrow", "yaml", "aiohttp", "websockets",
             "google.protobuf"):
    sys.modules[name] = None  # any import of these now fails
import asyncio
import json
from arkflow_tpu_torch.components import ensure_plugins_loaded
from arkflow_tpu_torch.config import StreamConfig
from arkflow_tpu_torch.runtime.stream import build_stream

ensure_plugins_loaded()
stream = build_stream(StreamConfig.from_mapping({
    "input": {"type": "generate", "batch_size": 64, "count": 320,
              "payload": '{"sensor": "temperature", "value": 42.5, "station": "eu-1"}'},
    "pipeline": {"thread_num": 4, "processors": [
        {"type": "json_to_arrow"},
        {"type": "sql", "query": "SELECT sensor, value * 1.8 + 32 AS fahrenheit, station "
                                 "FROM flow WHERE value > 10"},
        {"type": "remap", "mappings": {"f2": "round(fahrenheit, 1)"}},
        {"type": "arrow_to_json"}]},
    "output": {"type": "drop"}}))
asyncio.run(stream.run(asyncio.Event()))
assert stream.output.dropped_rows == 320 and stream.errors == 0, stream.errors
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "arkflow_tpu", "pyarrow")
          and sys.modules[m] is not None]
assert not leaked, leaked
print("SQL_OK")
"""

SQL_FILES = sorted((ROOT / "arkflow_tpu_torch" / "sql").glob("*.py")) + [
    ROOT / "arkflow_tpu_torch" / "plugins" / "processor" / "sql.py",
    ROOT / "arkflow_tpu_torch" / "plugins" / "processor" / "remap.py",
    ROOT / "arkflow_tpu_torch" / "utils" / "expr.py"]


@pytest.mark.parametrize("path", SQL_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sql_modules_import_no_pyarrow_anywhere(path):
    """The SQL engine and its users compute without Arrow: no import of
    pyarrow at any level, not even inside a function."""
    tree = ast.parse(path.read_text(), filename=str(path))
    assert "pyarrow" not in list(_imports(tree, top_level_only=False)), path


def test_sql_stream_runs_with_jax_reference_and_pyarrow_blocked():
    """BASELINE config 1's stream (generate -> json_to_arrow -> sql, then a
    remap and arrow_to_json) with JAX, the JAX package and pyarrow blocked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _SQL_CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SQL_OK" in proc.stdout


def test_broker_examples_run_with_jax_and_reference_blocked():
    """The eight broker examples at a tiny width on the CPU through
    ``tools/broker_streams.py`` and ``tools/fake_brokers.py``, with JAX, the
    JAX package, pyarrow, yaml, aiohttp, websockets, protobuf, zstandard and
    transformers blocked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _BROKER_CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BROKERS_OK" in proc.stdout


def test_port_imports_and_streams_with_jax_and_reference_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT_OK" in proc.stdout


_OBS_CHILD = r"""
import sys
for name in ("jax", "jaxlib", "arkflow_tpu", "torch", "numpy", "pyarrow", "yaml", "aiohttp"):
    sys.modules[name] = None  # the observability plane needs none of these
from arkflow_tpu_torch.obs import MetricsRegistry, Tracer, TracingConfig, activate, stage_span
from arkflow_tpu_torch.obs import global_registry, global_tracer, record_stage

t = Tracer(config=TracingConfig())
ctx = t.begin()
with activate(t, ctx):
    with stage_span("process"):
        record_stage("device_step", 0.001)
assert t.finish(ctx, "ok", e2e_s=0.01)
assert t.stage_breakdown()["stages"]["device_step"]["nested_under"] == "process"
assert "arkflow_stage_seconds_count" in global_registry().exposition()
assert global_tracer().enabled in (True, False)
print("OBS_OK")
"""


def test_obs_plane_is_scanned_and_stands_alone():
    """``arkflow_tpu_torch/obs`` is among the scanned port files, and it
    imports and runs with JAX, the JAX package, torch and numpy blocked."""
    obs = {p.name for p in PORT_FILES if p.parent.name == "obs"}
    assert obs == {"__init__.py", "metrics.py", "trace.py"}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _OBS_CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OBS_OK" in proc.stdout


_CONTROL_CHILD = r"""
import sys
for name in ("jax", "jaxlib", "arkflow_tpu", "torch", "numpy", "pyarrow", "yaml", "aiohttp"):
    sys.modules[name] = None  # the controller and the cache need none of these
from arkflow_tpu_torch.runtime.overload import FairQueue, OverloadConfig, OverloadController
from arkflow_tpu_torch.runtime.respcache import build_response_cache

ctrl = OverloadController(OverloadConfig.from_config({"tenants": {}}, deadline_ms=100.0))
assert ctrl.admit(0, 50.0, tenant="t") is None
assert build_response_cache(True, name="m") is not None
for name in ("torch", "numpy"):
    del sys.modules[name]
import asyncio
import json

from arkflow_tpu_torch.components import ensure_plugins_loaded
from arkflow_tpu_torch.config import EngineConfig
from arkflow_tpu_torch.runtime.engine import Engine

ensure_plugins_loaded()
raw = json.load(open("arkflow_tpu_torch/examples/overload_stream.json"))
raw["health_check"]["port"] = 0
s = raw["streams"][0]
s["input"]["inner"].update(count=80, interval="1ms")
s["pipeline"]["processors"][0]["faults"][0]["duration"] = "3ms"
s["output"] = s["error_output"] = {"type": "drop"}
eng = Engine(EngineConfig.from_mapping(raw))
st = eng.build()[0]
asyncio.run(eng.run())
shed = sum(c.value for c in st.overload.m_shed.values())
assert st.m_batches_in.value == st.m_batches_out.value + shed == 160, (st.m_batches_in.value, shed)
tiny = {"vocab_size": 128, "hidden": 16, "layers": 1, "heads": 2, "ffn": 32,
        "max_positions": 64}
raw = json.load(open("arkflow_tpu_torch/examples/multitenant_bert_stream.json"))
raw["health_check"]["port"] = 0
s = raw["streams"][0]
s["input"]["port"] = 0
s["pipeline"]["processors"][0].update(model_config=tiny, device="cpu")
s["output"] = s["error_output"] = {"type": "drop"}
eng = Engine(EngineConfig.from_mapping(raw))
st = eng.build()[0]


async def post(port, tenant, body):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(("POST /infer HTTP/1.1\r\nHost: x\r\nX-Tenant-Id: %s\r\nContent-Length: %d\r\n\r\n"
             % (tenant, len(body))).encode() + body)
    await w.drain()
    status = int((await r.readline()).split()[1])
    w.close()
    return status


async def drive():
    task = asyncio.ensure_future(eng.run())
    while not st.input.port:
        await asyncio.sleep(0.05)
    statuses = [await post(st.input.port, t, b"text %d" % i)
                for i, t in enumerate(["premium", "free", "other"] * 4)]
    await asyncio.sleep(0.5)
    eng.shutdown()
    await asyncio.wait_for(task, 60)
    return statuses


assert asyncio.run(drive()) == [200] * 12
assert st.output.dropped_rows + st.error_output.dropped_rows == 12  # delivered or shed
assert set(st.overload.report()["tenants"]) == {"premium", "free", "other"}
crash = {"kind": "crash", "at": 2}
eng = Engine(EngineConfig.from_mapping({"streams": [{
    "name": "restart", "restart": {"max_retries": 2, "backoff": "10ms"},
    "input": {"type": "fault", "faults": [crash], "inner": {"type": "memory", "messages": ["a"] * 3}},
    "pipeline": {"thread_num": 1, "processors": []}, "output": {"type": "drop"}}]}))
asyncio.run(eng.run())
assert eng.stream_health()["restart"]["restarts"] == 1 and crash["_state"]["fired"] == 1
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "arkflow_tpu")
          and sys.modules[m] is not None]
assert not leaked, leaked
print("CONTROL_OK")
"""


def test_control_plane_runs_with_jax_and_reference_blocked():
    """``runtime/overload.py`` and ``runtime/respcache.py`` import and decide
    with JAX, the JAX package, torch, numpy, pyarrow, yaml and aiohttp
    blocked; then ``overload_stream.json`` (its burst at a few hundred rows),
    ``multitenant_bert_stream.json`` (HTTP with ``tenant_header`` at a tiny
    width on the CPU) and a restarting stream run with JAX and the JAX
    package blocked."""
    assert {"overload.py", "respcache.py"} <= {p.name for p in PORT_FILES
                                                 if p.parent.name == "runtime"}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _CONTROL_CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CONTROL_OK" in proc.stdout


_FILE_PULSAR_CHILD = r"""
import sys
for name in ("jax", "jaxlib", "arkflow_tpu", "pyarrow", "yaml", "aiohttp", "websockets",
             "google.protobuf", "zstandard", "transformers"):
    sys.modules[name] = None  # any import of these now fails
import asyncio
import csv
import json
import os
import tempfile

from arkflow_tpu_torch.tools import broker_streams as bs
from arkflow_tpu_torch.utils.avro import write_container

def example(name):
    return json.load(open("arkflow_tpu_torch/examples/" + name))

tmp = tempfile.mkdtemp()
rows = [{"id": i, "text": f"msg{i} " + "w " * (i % 9)} for i in range(24)]
with open(os.path.join(tmp, "t.csv"), "w", newline="") as f:
    w = csv.writer(f)
    w.writerow(["id", "text"])
    w.writerows([r["id"], r["text"]] for r in rows[:12])
with open(os.path.join(tmp, "t.ndjson"), "w") as f:
    f.writelines(json.dumps(r) + "\n" for r in rows[12:])
raw = example("file_bert_pulsar.json")
s = raw["streams"][0]
s["pipeline"]["processors"][0].update(
    device="cpu", warmup=False, max_seq=32, batch_buckets=[4, 8], seq_buckets=[32],
    model_config={"vocab_size": 128, "hidden": 16, "layers": 1, "heads": 2, "ffn": 32,
                  "max_positions": 64})
s["buffer"].update(capacity=8)
s["buffer"]["coalesce"].update(batch_buckets=[8], token_budget=256, max_row_tokens=32)
rep = asyncio.run(bs.file_to_pulsar(raw, [os.path.join(tmp, "t.csv"),
                                          os.path.join(tmp, "t.ndjson")]))
ids = [json.loads(p)["id"] for p in rep["payloads"]]
assert sorted(ids) == [i for i in range(24) if i % 4 != 3] and rep["errors"] == 0, rep
vals = [json.dumps({"sensor": f"s{i}", "value": i}).encode() for i in range(20)]
rep = asyncio.run(bs.pulsar_to_pulsar(example("pulsar_example.json"), vals))
assert [json.loads(p)["sensor"] for p in rep["payloads"]] == [f"s{i}" for i in range(11, 20)]
assert rep["unacked"] == 0 and rep["redelivered"] == 0, rep
schema = {"type": "record", "name": "E", "fields": [
    {"name": "id", "type": "long"}, {"name": "name", "type": "string"},
    {"name": "ok", "type": "boolean"}]}
with open(os.path.join(tmp, "e.avro"), "wb") as f:
    write_container(f, schema, [{"id": i, "name": f"n{i}", "ok": i % 2 == 0}
                                for i in range(20000)], codec="deflate")
rep = asyncio.run(bs.file_to_stdout(example("avro_file_example.json"),
                                    os.path.join(tmp, "e.avro")))
assert [json.loads(x)["id"] for x in rep["lines"]] == list(range(0, 20000, 2)), rep["rows_out"]
leaked = [m for m in sys.modules if (m.split(".")[0] in ("jax", "arkflow_tpu", "pyarrow",
                                                         "transformers")
                                     or m.startswith("google.protobuf"))
          and sys.modules[m] is not None]
assert not leaked, leaked
print("FILE_PULSAR_OK")
"""


def test_file_and_pulsar_examples_run_with_pyarrow_and_protobuf_blocked():
    """``file_bert_pulsar.json`` at a tiny width, ``pulsar_example.json`` and
    ``avro_file_example.json`` through ``tools/broker_streams.py`` on the
    port's fake Pulsar broker, with JAX, the JAX package, pyarrow and
    google.protobuf blocked: the port reads CSV, NDJSON and Avro and speaks
    Pulsar's protocol on its own code."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _FILE_PULSAR_CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FILE_PULSAR_OK" in proc.stdout
