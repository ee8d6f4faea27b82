"""The port's observability plane through its streams and engine, against the
JAX package's on the same batches and weights: per-trace stage names, the
redelivery's trace, quarantine, coalesced emissions, counter deltas under the
delivery scenarios, ``arkflow_e2e_seconds`` against the batches written,
``/metrics``, ``/trace``, ``/health``'s ``tracing`` and ``/debug/profile`` on
a loopback ``port: 0``, the idle-gap histogram, and metric names and help
texts equal to the JAX package's. Mirrors ``tests/test_tracing.py``.

Both packages' registries and tracers are process-global: every comparison
clears both before it runs (``_fresh``)."""

import ast
import asyncio
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest

from arkflow_tpu.config import StreamConfig as JaxStreamConfig
from arkflow_tpu.obs import global_registry as jax_registry
from arkflow_tpu.obs.trace import TracingConfig as JaxTracingConfig
from arkflow_tpu.obs.trace import global_tracer as jax_tracer
from arkflow_tpu.runtime import build_stream as jax_build_stream
from arkflow_tpu_torch.batch import META_EXT_TRACE
from arkflow_tpu_torch.components import Processor, ensure_plugins_loaded
from arkflow_tpu_torch.config import EngineConfig, StreamConfig
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.obs import global_registry
from arkflow_tpu_torch.obs.metrics import Counter, Gauge, Histogram
from arkflow_tpu_torch.obs.trace import TracingConfig, global_tracer
from arkflow_tpu_torch.runtime.engine import PROFILE_FILE, Engine
from arkflow_tpu_torch.runtime.stream import build_stream
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy
from arkflow_tpu_torch.tpu.runner import ModelRunner
from tests import test_torch_delivery as delivery
from tests.test_obs_and_misc import _parse_prometheus_text
from tests.test_torch_connectors import read_response
from tests.test_tpu_layer import TINY_BERT

ensure_plugins_loaded()

ROOT = Path(__file__).resolve().parent.parent
PAYLOADS = ["ok", "sensor reading looks fine", "pressure spike on line four, check valve",
            " ".join(f"token{i}" for i in range(20)), "a b c d e f g h"]
#: the stages every traced batch of a BERT stream records
BERT_STAGES = {"input_decode", "queue_wait", "process", "infeed_prep", "device_step",
               "output_write"}


def _fresh(sample_rate: float = 1.0) -> None:
    for reg, tracer, cfg in ((global_registry(), global_tracer(), TracingConfig),
                             (jax_registry(), jax_tracer(), JaxTracingConfig)):
        reg.clear()
        tracer.configure(cfg(sample_rate=sample_rate), tier="ingest")
        tracer.clear()


def _values(reg, names=None) -> dict:
    """Counter and gauge values and histogram counts by (name, labels but
    the stream's), for the families in ``names`` (all when None)."""
    out = {}
    for m in reg.collect():
        if names is not None and m.name not in names:
            continue
        key = (m.name, tuple(sorted((k, v) for k, v in m.labels.items() if k != "stream")))
        out[key] = m.count if hasattr(m, "count") else m.value
    return out


def _stages(tracer, status: str = "ok") -> list:
    return sorted(tuple(sorted({s["stage"] for s in r["spans"]}))
                  for r in tracer.slowest(1000) if r["status"] == status)


def _run(stream, timeout: float = 30) -> None:
    asyncio.run(asyncio.wait_for(stream.run(asyncio.Event()), timeout))


def _bert_cfg(kind: str, **extra) -> dict:
    proc = {"type": kind, "model": "bert_classifier", "model_config": TINY_BERT, "max_seq": 32,
            "batch_buckets": [4, 8], "seq_buckets": [16, 32], "warmup": True,
            "outputs": ["label", "score"], **extra}
    if kind == "gpu_inference":
        proc["device"] = "cpu"
    return {"name": "traced", "input": {"type": "generate", "payloads": PAYLOADS,
                                        "batch_size": 4, "count": 12},
            "pipeline": {"thread_num": 1, "processors": [proc]}, "output": {"type": "drop"}}


STREAM_FAMILIES = ("arkflow_rows_in_total", "arkflow_rows_out_total", "arkflow_batches_in_total",
                   "arkflow_batches_out_total", "arkflow_process_errors_total",
                   "arkflow_write_errors_total", "arkflow_e2e_seconds",
                   "arkflow_process_seconds", "arkflow_queue_wait_seconds",
                   "arkflow_output_write_seconds", "arkflow_input_read_seconds",
                   "arkflow_output_retries_total", "arkflow_quarantined_batches_total",
                   "arkflow_quarantine_drops_total", "arkflow_ack_failures_total",
                   "arkflow_circuit_state", "arkflow_circuit_trips_total")
RUNNER_FAMILIES = ("arkflow_tpu_rows_total", "arkflow_tpu_infer_seconds",
                   "arkflow_tpu_pad_rows_total", "arkflow_tpu_exec_rows_total",
                   "arkflow_tpu_tokens_total", "arkflow_tpu_token_capacity_total",
                   "arkflow_tpu_batch_fill_ratio", "arkflow_padding_waste_frac",
                   "arkflow_tpu_infeed_prep_seconds", "arkflow_tpu_extract_seconds",
                   "arkflow_tpu_oom_total", "arkflow_tpu_bucket_cap",
                   "arkflow_tpu_runner_health", "arkflow_tpu_step_deadline_misses",
                   "arkflow_tpu_runner_rebuilds_total")
#: families of the JAX runner that the port leaves out (no donation, no pp)
LEFT_OUT = {"arkflow_tpu_donate_active", "arkflow_pp_bubble_frac"}


def test_bert_stream_traces_and_counters_equal_jax_s():
    """The padded BERT stream on the same weights in both packages: every
    committed trace holds the same stage names, root spans after the ingest
    stamp sum to at most e2e, and the stream's and runner's counters (and
    the e2e count, one a written batch) equal JAX's."""
    _fresh()
    jax_stream = jax_build_stream(JaxStreamConfig.from_mapping(_bert_cfg("tpu_inference")))
    _run(jax_stream)
    want = {"stages": _stages(jax_tracer()),
            "values": _values(jax_registry(), STREAM_FAMILIES + RUNNER_FAMILIES)}
    jax_families = {m.name for m in jax_registry().collect()}
    host = jax.device_get(jax_stream.pipeline.processors[0].runner.host_params)

    _fresh()
    stream = build_stream(StreamConfig.from_mapping(_bert_cfg("gpu_inference")))
    proc = stream.pipeline.processors[0]
    proc.runner = ModelRunner("bert_classifier", TINY_BERT, buckets=proc.runner.buckets,
                              device="cpu", host_params=params_from_jax(host))
    _run(stream)
    got = {"stages": _stages(global_tracer()),
           "values": _values(global_registry(), STREAM_FAMILIES + RUNNER_FAMILIES)}
    assert got == want
    assert got["stages"] == [tuple(sorted(BERT_STAGES))] * 3
    vals = dict(got["values"])
    assert vals[("arkflow_rows_in_total", ())] == vals[("arkflow_rows_out_total", ())] == 12
    assert vals[("arkflow_e2e_seconds", ())] == vals[("arkflow_batches_out_total", ())] == 3
    for rec in global_tracer().slowest(10):
        roots = sum(s["dur_ms"] for s in rec["spans"]
                    if not s["parent_id"] and s["stage"] != "input_decode")
        assert roots <= rec["e2e_ms"] + 1.0, rec
        process = next(s for s in rec["spans"] if s["stage"] == "process")
        for s in rec["spans"]:
            if s["stage"] in ("infeed_prep", "device_step"):
                assert s["parent_id"] == process["span_id"]
    ports = {m.name for m in global_registry().collect()}
    assert ports <= jax_families and jax_families - ports <= LEFT_OUT


class _Flaky(Processor):
    """Fails its first ``fails`` calls, then passes batches through."""

    def __init__(self, fails: int = 1, always: bool = False):
        self.calls, self.fails, self.always = 0, fails, always

    async def process(self, batch):
        self.calls += 1
        if self.always or self.calls <= self.fails:
            raise RuntimeError(f"injected failure on call {self.calls}")
        return [batch]


def _jax_flaky(fails: int = 1, always: bool = False):
    from arkflow_tpu.components import Processor as JaxProcessor

    class Flaky(JaxProcessor):
        def __init__(self):
            self.calls = 0

        async def process(self, batch):
            self.calls += 1
            if always or self.calls <= fails:
                raise RuntimeError(f"injected failure on call {self.calls}")
            return [batch]

    return Flaky()


def _both_streams(cfg: dict, patch_port, patch_jax, sample_rate: float = 1.0) -> dict:
    """``cfg`` through each package's stream (patched): per package, the
    committed traces' (status, stage names) and the tracer."""
    out = {}
    for name, build, conf, patch, tracer in (
            ("jax", jax_build_stream, JaxStreamConfig, patch_jax, jax_tracer),
            ("port", build_stream, StreamConfig, patch_port, global_tracer)):
        _fresh(sample_rate)
        stream = build(conf.from_mapping(json.loads(json.dumps(cfg))))
        patch(stream)
        _run(stream)
        recs = tracer().slowest(1000)
        out[name] = {"traces": sorted((r["status"], tuple(sorted({s["stage"] for s in r["spans"]})))
                                      for r in recs),
                     "recs": recs, "stream": stream}
    assert out["port"]["traces"] == out["jax"]["traces"]
    return out


def test_redelivery_keeps_its_trace_id_and_forces_an_error_commit():
    cfg = {"name": "t-redeliver",
           "input": {"type": "fault", "seed": 5, "redeliver_unacked": True,
                     "inner": {"type": "memory", "messages": ["r1"]},
                     "faults": [{"kind": "latency", "every": 100, "duration": "1ms"}]},
           "pipeline": {"thread_num": 1, "max_delivery_attempts": 3, "processors": []},
           "output": {"type": "drop"}}
    out = _both_streams(cfg, lambda s: s.pipeline.processors.append(_Flaky()),
                        lambda s: s.pipeline.processors.append(_jax_flaky()))
    recs = out["port"]["recs"]
    errors = [r for r in recs if r["status"] == "error"]
    oks = [r for r in recs if r["status"] == "ok"]
    assert len(errors) == 1 and len(oks) == 1 and errors[0]["trace_id"] == oks[0]["trace_id"]
    assert errors[0]["attrs"] == {"error": "injected failure on call 1", "attempt": 1}
    assert any(s.get("attrs", {}).get("redelivered")
               for s in oks[0]["spans"] if s["stage"] == "input_decode")


def test_quarantine_keeps_the_trace_column_and_commits_error():
    cfg = {"name": "t-quarantine", "input": {"type": "memory", "messages": ["p1"]},
           "pipeline": {"thread_num": 1, "max_delivery_attempts": 1, "processors": []},
           "output": {"type": "drop"}, "error_output": {"type": "drop"}}
    quarantined = {"jax": [], "port": []}

    def patcher(name, flaky):
        def patch(stream):
            stream.pipeline.processors.append(flaky)
            inner_write = stream.error_output.write

            async def write(batch):
                quarantined[name].append(batch)
                await inner_write(batch)

            stream.error_output.write = write
        return patch

    out = _both_streams(cfg, patcher("port", _Flaky(always=True)),
                        patcher("jax", _jax_flaky(always=True)), sample_rate=0.0)
    (batch,) = quarantined["port"]
    assert batch.has_column(META_EXT_TRACE)
    assert batch.get_meta("__meta_ext_error") == "injected failure on call 1"
    (rec,) = [r for r in out["port"]["recs"] if r["status"] == "error"]
    assert rec["trace_id"] == batch.trace_context().trace_id and rec["forced"]
    assert quarantined["jax"][0].column(META_EXT_TRACE).to_pylist()[0] is not None


def test_coalesced_emission_links_its_source_traces():
    cfg = {"name": "t-coalesce", "input": {"type": "memory", "messages": ["a", "b", "c", "d"]},
           "buffer": {"type": "memory", "capacity": 64, "timeout": "20ms",
                      "coalesce": {"batch_buckets": [4], "deadline": "20ms"}},
           "pipeline": {"thread_num": 1, "processors": []}, "output": {"type": "drop"}}
    out = _both_streams(cfg, lambda s: None, lambda s: None)
    recs = out["port"]["recs"]
    merged = [r for r in recs if r["status"] == "ok"]
    coalesced = [r for r in recs if r["status"] == "coalesced"]
    assert len(merged) == 1 and len(coalesced) == 4
    (wait,) = [s for s in merged[0]["spans"] if s["stage"] == "coalesce_wait"]
    assert set(wait["attrs"]["links"]) == {r["trace_id"] for r in coalesced}
    assert all(r["attrs"]["merged_into"] == merged[0]["trace_id"] for r in coalesced)


#: the delivery scenarios of tests/test_torch_delivery.py: faults, retries,
#: quarantines, a breaker trip, ack failures
SCENARIOS = {"e2e": delivery._e2e, "breaker": delivery._breaker,
             "errout_retry": delivery._errout_retry, "errout_dead": delivery._errout_dead,
             "ack_faults": delivery._ack_faults}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_delivery_counter_deltas_equal_jax_s(name):
    got = {}
    for pkg, reg in ((delivery.JAX, jax_registry), (delivery.PORT, global_registry)):
        _fresh()
        SCENARIOS[name](pkg)
        got[pkg.name] = _values(reg(), STREAM_FAMILIES)
    assert got["port"] == got["jax"]
    vals = got["port"]
    assert vals[("arkflow_e2e_seconds", ())] == vals[("arkflow_batches_out_total", ())]


# -- the engine's routes ----------------------------------------------------------


async def _request(port: int, method: str, target: str):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"{method} {target} HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n".encode())
    await writer.drain()
    try:
        return await asyncio.wait_for(read_response(reader), 30)
    finally:
        writer.close()


def _engine(**health) -> Engine:
    return Engine(EngineConfig.from_mapping({
        "health_check": {"enabled": True, "host": "127.0.0.1", "port": 0, **health},
        "tracing": {"sample_rate": 1.0, "max_traces": 64},
        "streams": [{"name": "live", "input": {"type": "generate", "payload": "live",
                                               "interval": "10ms", "batch_size": 2,
                                               "count": 10 ** 6},
                     "pipeline": {"thread_num": 1, "processors": []},
                     "output": {"type": "drop"}}]}))


async def _serving(engine: Engine, body) -> None:
    task = asyncio.create_task(engine.run())
    try:
        while engine.health_port is None or not engine._ready or global_tracer().commit_seq() < 3:
            await asyncio.sleep(0.02)
        await body(engine.health_port)
    finally:
        engine.shutdown()
        await asyncio.wait_for(task, 10)


def test_metrics_trace_and_health_routes():
    _fresh()
    global_tracer().configure(TracingConfig(enabled=False))  # the engine turns it on

    async def body(port):
        status, hdrs, text = await _request(port, "GET", "/metrics")
        assert status == 200 and hdrs["content-type"] == "text/plain; charset=utf-8"
        fams = _parse_prometheus_text(text.decode())
        rows = {lab["stream"]: v for _, lab, v in fams["arkflow_rows_in_total"]["samples"]}
        assert rows["live"] >= 6 and fams["arkflow_e2e_seconds"]["type"] == "histogram"
        samples = fams["arkflow_e2e_seconds"]["samples"]
        buckets = [v for n, _, v in samples if n.endswith("_bucket")]
        assert buckets == sorted(buckets)
        assert buckets[-1] == next(v for n, _, v in samples if n.endswith("_count"))
        assert "arkflow_stage_seconds" in fams
        status, _, raw = await _request(port, "GET", "/trace?n=2&min_seq=0")
        body = json.loads(raw)
        assert status == 200 and body["summary"]["enabled"] is True
        assert body["stage_breakdown"]["traces"] >= 3 and 0 < len(body["slowest"]) <= 2
        assert {"input_decode", "queue_wait", "process", "output_write"} <= {
            s["stage"] for s in body["slowest"][0]["spans"]}
        seq = global_tracer().commit_seq()
        status, _, raw = await _request(port, "GET", f"/trace?min_seq={seq + 10 ** 6}")
        assert json.loads(raw)["slowest"] == []
        for bad in ("/trace?n=x", "/trace?min_seq=1.5"):
            status, _, raw = await _request(port, "GET", bad)
            assert (status, json.loads(raw)) == (400, {"error": "n/min_seq must be ints"})
        status, _, raw = await _request(port, "GET", "/health")
        tracing = json.loads(raw)["tracing"]
        assert tracing["enabled"] is True and tracing["traces_retained"] > 0
        assert set(tracing) == set(jax_tracer().summary())
        status, _, raw = await _request(port, "POST", "/debug/profile")
        assert status == 404

    asyncio.run(asyncio.wait_for(_serving(_engine(), body), 60))


def test_debug_profile_route(tmp_path):
    _fresh()
    prof_dir = tmp_path / "prof"

    async def body(port):
        for target, text in (("/debug/profile?seconds=abc", b"seconds must be a number"),
                             ("/debug/profile?seconds=nan", b"seconds must be finite"),
                             ("/debug/profile?seconds=inf", b"seconds must be finite")):
            status, hdrs, raw = await _request(port, "POST", target)
            assert (status, raw) == (400, text)
            assert hdrs["content-type"] == "text/plain; charset=utf-8"
        assert (await _request(port, "GET", "/debug/profile"))[0] == 405
        first = asyncio.ensure_future(_request(port, "POST", "/debug/profile?seconds=0.01"))
        await asyncio.sleep(0.05)
        status, _, raw = await _request(port, "POST", "/debug/profile?seconds=1")
        assert (status, raw) == (409, b"a capture is already running")
        status, _, raw = await first
        body = json.loads(raw)
        assert status == 200 and body["seconds"] == 0.1  # clamped up
        assert body["trace_dir"].startswith(str(prof_dir) + "/trace-")
        with open(os.path.join(body["trace_dir"], PROFILE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("cat") == "cpu_op" or e.get("ph") == "X" for e in events)

    asyncio.run(asyncio.wait_for(_serving(_engine(profiling_dir=str(prof_dir) + "/"), body), 60))


def test_profile_failure_answers_500_and_stops_the_profiler(tmp_path, monkeypatch):
    import torch.profiler as tp

    engine = _engine(profiling_dir=str(tmp_path / "p"))
    stopped = []

    class Broken(tp.profile):
        def stop(self):
            super().stop()
            stopped.append(True)

        def export_chrome_trace(self, path):
            raise OSError("disk full")

    monkeypatch.setattr(tp, "profile", Broken)
    status, body = asyncio.run(engine._route("POST", "/debug/profile?seconds=0.1", b""))
    assert (status, body) == (500, "profile failed: disk full") and stopped == [True]


def test_idle_gap_histogram_and_device_stages_after_a_stream():
    """Two steps on the async path leave one idle gap; a stream at dispatch
    depth 2, packed, records its device steps under ``process``."""
    _fresh()
    runner = ModelRunner("bert_classifier", {**TINY_BERT, "max_positions": 32}, device="cpu",
                         buckets=BucketPolicy((2,), (16,)))
    inputs = {"input_ids": np.zeros((2, 16), np.int32),
              "attention_mask": np.ones((2, 16), np.int32)}

    async def go():
        await runner.infer(inputs)
        await runner.infer(inputs)

    asyncio.run(go())
    (gap,) = [m for m in global_registry().collect()
              if m.name == "arkflow_tpu_device_idle_gap_seconds"]
    assert gap.count >= 1 and dict(gap.labels) == {"model": "bert_classifier"}
    busy = global_registry().counter("arkflow_tpu_device_busy_seconds_total",
                                     labels={"model": "bert_classifier"})
    assert busy.value > 0 and runner.duty_cycle() > 0

    _fresh()
    cfg = _bert_cfg("gpu_inference", packing=True, dispatch_depth=2, warmup=False)
    cfg["buffer"] = {"type": "memory", "capacity": 64, "timeout": "5ms",
                     "coalesce": {"batch_buckets": [4, 8], "token_budget": 96,
                                  "deadline": "5ms"}}
    cfg["pipeline"]["thread_num"] = 2
    cfg["input"]["count"] = 64
    _run(build_stream(StreamConfig.from_mapping(cfg)))
    recs = [r for r in global_tracer().slowest(1000) if r["status"] == "ok"]
    assert recs
    for rec in recs:
        stages = {s["stage"] for s in rec["spans"]}
        assert {"process", "infeed_prep", "queue_wait"} <= stages, stages
        assert stages & {"device_step", "device_step_first"}
        assert stages & {"buffer_wait", "coalesce_wait"}
    # the depth-2 split path (a key's later steps) records device_step too
    assert any(s["stage"] == "device_step" for r in recs for s in r["spans"])


def test_generation_metrics_follow_the_server_counters():
    from tests.test_torch_stream import _generate_stream

    _fresh()
    stream = build_stream(StreamConfig.from_mapping(_generate_stream("gpu_generate")))
    _run(stream, 60)
    server = stream.pipeline.processors[0].server
    reg = global_registry()
    assert reg.counter("arkflow_gen_tokens_total").value == server.tokens > 0
    assert reg.counter("arkflow_gen_decode_steps_total").value == (server.decode_steps
                                                                  + server.verify_steps)
    ttft = reg.histogram("arkflow_gen_ttft_seconds", labels={"model": "decoder_lm"})
    assert ttft.count == len(server.ttft_samples) == stream.rows_out
    assert reg.counter("arkflow_generated_tokens_total",
                       labels={"model": "decoder_lm"}).value == server.tokens
    assert reg.gauge("arkflow_gen_dispatch_depth", labels={"model": "decoder_lm"}).value == 2
    assert reg.gauge("arkflow_gen_decode_kernel_paged", labels={"model": "decoder_lm"}).value == 0


# -- names and help texts -------------------------------------------------------------


def _registered(path: Path) -> set:
    """(name, help) of every metric a module registers with a literal name
    (``reg.counter/gauge/histogram(name, help, ...)``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("counter", "gauge", "histogram") and node.args
                and isinstance(node.args[0], ast.Constant)
                and str(node.args[0].value).startswith("arkflow_")):
            help_ = (node.args[1].value if len(node.args) > 1
                     and isinstance(node.args[1], ast.Constant) else None)
            out.add((node.args[0].value, help_))
    return out


MODULES = [("obs/trace.py", "obs/trace.py"), ("runtime/stream.py", "runtime/stream.py"),
           ("tpu/runner.py", "tpu/runner.py"), ("tpu/serving_core.py", "tpu/serving_core.py"),
           ("tpu/serving.py", "tpu/serving.py"), ("tpu/tuner.py", "tpu/tuner.py"),
           ("tpu/swap.py", "tpu/swap.py"), ("tpu/integrity.py", "tpu/integrity.py"),
           ("plugins/processor/gpu_inference.py", "plugins/processor/tpu_inference.py"),
           ("plugins/processor/gpu_generate.py", "plugins/processor/tpu_generate.py")]


@pytest.mark.parametrize("port_path,jax_path", MODULES, ids=[m[0] for m in MODULES])
def test_metric_names_and_help_are_jax_s(port_path, jax_path):
    port = _registered(ROOT / "arkflow_tpu_torch" / port_path)
    ref = _registered(ROOT / "arkflow_tpu" / jax_path)
    assert port and port <= ref
    assert {n for n, _ in ref} - {n for n, _ in port} <= LEFT_OUT


def test_metric_kinds_of_a_runner_equal_jax_s():
    _fresh()
    ModelRunner("bert_classifier", TINY_BERT, device="cpu", buckets=BucketPolicy((2,), (16,)))
    kinds = {m.name: type(m).__name__ for m in global_registry().collect()}
    assert kinds["arkflow_tpu_infer_seconds"] == Histogram.__name__
    assert kinds["arkflow_tpu_rows_total"] == Counter.__name__
    assert kinds["arkflow_tpu_bucket_cap"] == Gauge.__name__
    assert global_registry().gauge("arkflow_tpu_prefetch_active",
                                   labels={"model": "bert_classifier"}).value == 0
    assert global_registry().gauge("arkflow_tpu_bucket_cap",
                                   labels={"model": "bert_classifier"}).value == 2
