"""The lifecycle of a ``gpu_inference`` stream on the CPU: the deadline miss
of ``tests/test_selfheal.py`` in a stream (the batch nacks, the redelivery
heals, nothing is lost), the engine's stdlib health server on a loopback
port (``/health``, ``/readiness``, ``/liveness``, ``POST /admin/swap`` and
the routes not yet ported), and ``examples/bert_lifecycle_stream.json`` at
``TINY_BERT`` with ``device: cpu``."""

import asyncio
import json
import time
from pathlib import Path

import pytest

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import (Input, NoopAck, Resource, build_component,
                                          ensure_plugins_loaded)
from arkflow_tpu_torch.config import EngineConfig, StreamConfig
from arkflow_tpu_torch.errors import ConfigError, EndOfInput
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.runtime import cli
from arkflow_tpu_torch.runtime.engine import Engine
from arkflow_tpu_torch.plugins.fault.schedule import FaultSchedule
from arkflow_tpu_torch.plugins.fault.wrappers import FaultInjectingInput
from arkflow_tpu_torch.runtime.pipeline import Pipeline
from arkflow_tpu_torch.runtime.stream import Stream, build_stream
from arkflow_tpu_torch.tpu import checkpoint
from arkflow_tpu_torch.tpu.bucketing import bucket_cap_bus
from arkflow_tpu_torch.tpu.runner import init_host_params
from tests.test_tpu_layer import TINY_BERT

ensure_plugins_loaded()

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "arkflow_tpu_torch" / "examples" / "bert_lifecycle_stream.json"
#: the example's model at a tiny width, long enough for its 256 seq bucket
TINY_WIDE = {**TINY_BERT, "max_positions": 256}


@pytest.fixture(autouse=True)
def _reset_cap_bus():
    yield
    bucket_cap_bus().reset()


def _wait_zombies(runner, timeout_s: float = 10.0) -> None:
    end = time.monotonic() + timeout_s
    while runner.core.zombies and time.monotonic() < end:
        time.sleep(0.02)
    assert runner.core.zombies == 0


async def _http(port: int, method: str, path: str, body=None, raw: bytes = None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else b"")
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {len(data)}\r\n\r\n"
                 .encode() + data)
    await writer.drain()
    resp = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    head, _, payload = resp.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(payload)


def test_stream_deadline_miss_nacks_and_redelivery_heals():
    """A single-runner stream: the hung step trips the watchdog, the batch
    nacks, the redelivered batch lands after the probe: nothing lost, one
    miss, HEALTHY."""
    stream = build_stream(StreamConfig.from_mapping({
        "name": "sh-deadline",
        "input": {"type": "fault", "redeliver_unacked": True,
                  "inner": {"type": "generate", "payloads": ["r0", "r1", "r2"],
                            "batch_size": 1, "count": 3}},
        "pipeline": {"thread_num": 1, "max_delivery_attempts": 5, "processors": [{
            "type": "fault", "faults": [{"kind": "hang", "at": 1, "duration": "2s"}],
            "inner": {"type": "gpu_inference", "model": "bert_classifier",
                      "model_config": TINY_BERT, "device": "cpu", "max_seq": 16,
                      "batch_buckets": [2], "seq_buckets": [16], "warmup": True,
                      "step_deadline": "1s", "step_deadline_first": "30s",
                      "health": {"probe_backoff": "50ms"}}}]},
        "output": {"type": "drop"}}))
    runner = stream.pipeline.processors[0].runner
    asyncio.run(asyncio.wait_for(stream.run(asyncio.Event()), 30))
    _wait_zombies(runner)
    assert stream.rows_out == 3 and stream.output.dropped_rows == 3  # nothing lost
    assert stream.errors == 1 and stream.input.redeliveries == 1  # the miss nacked
    assert runner.deadline_misses == 1 and runner.rebuilds == 1
    assert runner.health.state == "healthy"


def test_failed_batch_from_a_plain_source_is_acked():
    """Without a redelivering source the error is logged and the batch
    acked, as before."""
    stream = build_stream(StreamConfig.from_mapping({
        "input": {"type": "generate", "payload": "x", "count": 2},
        "pipeline": {"thread_num": 1, "processors": [{
            "type": "fault", "faults": [{"kind": "error", "at": 1}]}]},
        "output": {"type": "drop"}}))
    asyncio.run(asyncio.wait_for(stream.run(asyncio.Event()), 30))
    assert stream.errors == 1 and stream.rows_out == 1 and stream.dropped_batches == 1


class _ListInput(Input):
    """One one-row batch per payload, then EOF."""

    def __init__(self, payloads):
        self._left = list(payloads)

    async def connect(self) -> None:
        pass

    async def read(self):
        if not self._left:
            raise EndOfInput()
        return MessageBatch.new_binary([self._left.pop(0).encode()]), NoopAck()


def _poison_stream(attempts: int) -> Stream:
    """Three batches from a redelivering source; the one holding "poison"
    fails at every delivery."""
    res = Resource()
    proc = build_component("processor", {"type": "fault", "faults": [
        {"kind": "error", "match": "poison"}]}, res)
    return Stream(FaultInjectingInput(_ListInput(["a", "poison", "b"]), FaultSchedule([]),
                                      redeliver_unacked=True),
                  Pipeline([proc]), build_component("output", {"type": "drop"}, res),
                  max_delivery_attempts=attempts)


@pytest.mark.parametrize("attempts", [1, 3])
def test_batch_that_always_fails_is_dropped_after_its_attempts(attempts):
    """A batch that fails at every delivery is nacked until its last
    attempt, then acked and counted, and the stream drains (the JAX
    stream's ``max_delivery_attempts``, default 1: no nack at all)."""
    stream = _poison_stream(attempts)
    asyncio.run(asyncio.wait_for(stream.run(asyncio.Event()), 30))
    assert stream.rows_out == 2 and stream.output.dropped_rows == 2
    assert stream.errors == attempts and stream.input.redeliveries == attempts - 1
    assert stream.dropped_batches == 1 and not stream._attempts


def test_max_delivery_attempts_validation():
    for bad in (0, -1, True, "3", 2.0):
        with pytest.raises(ConfigError, match="max_delivery_attempts must be an int >= 1"):
            StreamConfig.from_mapping({"input": {"type": "generate"}, "output": {"type": "drop"},
                                       "pipeline": {"max_delivery_attempts": bad}})


def _tiny_swap_engine(tmp_path, **proc_extra) -> tuple[Engine, str]:
    fam = get_model("bert_classifier")
    ck = str(tmp_path / "seed1")
    checkpoint.save(ck, init_host_params(fam, fam.make_config(**TINY_BERT), 1))
    proc = {"type": "gpu_inference", "model": "bert_classifier", "model_config": TINY_BERT,
            "device": "cpu", "max_seq": 16, "batch_buckets": [2], "seq_buckets": [16],
            "warmup": True, "swap": {"canary": {"min_agreement": 0.0}},
            "integrity": {"probe_interval": "999s"}, **proc_extra}
    cfg = EngineConfig.from_mapping({
        "health_check": {"enabled": True, "host": "127.0.0.1", "port": 0},
        "streams": [{"name": "s", "input": {"type": "generate", "payload": "a b c",
                                            "batch_size": 2, "count": 10 ** 6,
                                            "interval": "20ms"},
                     "pipeline": {"thread_num": 1, "processors": [
                         {"type": "fault", "faults": [], "inner": proc}]},
                     "output": {"type": "drop"}}]})
    return Engine(cfg), ck


def test_health_server_routes_and_admin_swap(tmp_path):
    engine, ck = _tiny_swap_engine(tmp_path)

    async def go():
        task = asyncio.create_task(engine.run())
        try:
            while engine.health_port is None or not engine._ready:
                await asyncio.sleep(0.02)
            port = engine.health_port
            status, body = await _http(port, "GET", "/health")
            sh = body["stream_health"]["s"]
            assert status == 200 and body["streams"] == 1 and body["status"] == "ok"
            assert sh["runners"][0]["state"] == "healthy" and sh["swap"][0]["version"] == 0
            assert sh["integrity"][0]["probes"] == 0
            assert await _http(port, "GET", "/readiness") == (
                200, {"status": "ready", "runners": {"s": ["healthy"]}})
            assert await _http(port, "GET", "/liveness") == (200, {"status": "alive"})
            # the observability routes (no profiling_dir: no profile route)
            assert "tracing" in body and body["tracing"]["tier"] == "ingest"
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
            await writer.drain()
            head, _, text = (await asyncio.wait_for(reader.read(), 30)).partition(b"\r\n\r\n")
            writer.close()
            assert head.split()[1] == b"200" and b"text/plain; charset=utf-8" in head
            assert b'arkflow_tpu_runner_health{model="bert_classifier"}' in text
            status, body = await _http(port, "GET", "/trace")
            assert status == 200 and set(body) == {"summary", "stage_breakdown", "slowest"}
            assert (await _http(port, "GET", "/trace?n=x"))[0] == 400
            status, body = await _http(port, "POST", "/debug/profile")
            assert status == 404 and body == {"error": "no route /debug/profile"}
            assert (await _http(port, "GET", "/nowhere"))[0] == 404
            assert (await _http(port, "POST", "/admin/swap", raw=b"{nope"))[0] == 400
            assert (await _http(port, "POST", "/admin/swap", {"stream": "s"}))[0] == 400
            status, body = await _http(port, "POST", "/admin/swap",
                                       {"checkpoint": ck, "stream": "other"})
            assert status == 404
            status, body = await _http(port, "POST", "/admin/swap", {"checkpoint": ck})
            assert status == 200 and body["ok"] and body["results"]["s"][0]["version"] == 1
            status, body = await _http(port, "POST", "/admin/swap",
                                       {"checkpoint": str(tmp_path / "missing")})
            assert status == 409 and not body["ok"]
            assert "rolled back at restore" in body["results"]["s"][0]["error"]
            status, body = await _http(port, "GET", "/health")
            assert body["stream_health"]["s"]["swap"][0]["rolled_back"] == 1
            # every runner of the stream quarantined: not ready
            engine.streams[0].pipeline.processors[0].runner.health.mark_corrupt("test")
            status, body = await _http(port, "GET", "/readiness")
            assert status == 503 and body["dead_runner_streams"] == {"s": 1}
            assert body["runners"] == {"s": ["corrupt"]}
        finally:
            engine.shutdown()
            await asyncio.wait_for(task, 30)
        assert engine.health_port is None

    asyncio.run(asyncio.wait_for(go(), 60))


def test_readiness_503_when_every_runner_is_dead():
    engine = Engine(EngineConfig.from_mapping({
        "health_check": {"enabled": True, "host": "127.0.0.1", "port": 0},
        "streams": [{"name": "unused", "input": {"type": "generate", "payload": "x",
                                                 "count": 1},
                     "output": {"type": "drop"}}]}))

    class FakeRunner:
        def health_report(self):
            return [{"state": "dead"}, {"state": "corrupt"}]

    class FakeProc:
        runner = FakeRunner()

    class FakePipeline:
        processors = [FakeProc()]

    class FakeStream:
        name = "dead-pool"
        pipeline = FakePipeline()

    engine.streams = [FakeStream()]

    async def go():
        await engine.start_health_server()
        try:
            status, _ = await _http(engine.health_port, "GET", "/readiness")
            assert status == 503  # not ready before the streams run
            engine._ready = True
            status, body = await _http(engine.health_port, "GET", "/readiness")
            assert status == 503 and body["dead_runner_streams"] == {"dead-pool": 2}
        finally:
            await engine.stop_health_server()

    asyncio.run(asyncio.wait_for(go(), 30))


def test_lifecycle_example_validates_as_shipped():
    assert cli.main(["--config", str(EXAMPLE), "--validate"]) == 0


#: the example's hang and step deadline on the CPU. The card's 1 s deadline
#: is a hundred times its step; a CPU step at 64 x 256 shared with other
#: test processes has taken up to 1.9 s, and a second miss then breaks the
#: exact counts. 8 s sits four times above that, and the hang past it.
CPU_DEADLINE, CPU_HANG = "8s", "10s"


def test_lifecycle_example_at_tiny_width(tmp_path):
    """``bert_lifecycle_stream.json`` with the model at TINY_BERT width on
    the CPU: every row delivered, one miss and one rebuild, one OOM that
    caps the 64-row bucket, HEALTHY at the end, integrity probes passing.
    Only the hung step may miss its deadline (``CPU_DEADLINE``)."""
    cfg = json.loads(EXAMPLE.read_text())
    fault = cfg["streams"][0]["pipeline"]["processors"][0]
    proc = fault["inner"]
    assert fault["faults"][0]["kind"] == "hang"
    fault["faults"][0]["duration"] = CPU_HANG
    fam = get_model("bert_classifier")
    ck = str(tmp_path / "seed0")
    checkpoint.save(ck, init_host_params(fam, fam.make_config(**TINY_WIDE), 0))
    proc.update(model_config=TINY_WIDE, device="cpu", checkpoint=ck,
                step_deadline=CPU_DEADLINE)
    cfg["health_check"]["port"] = 0
    engine = Engine(EngineConfig.from_mapping(cfg))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]
    runner, mon = proc.runner, proc._inner.integrity
    count = cfg["streams"][0]["input"]["inner"]["count"]
    asyncio.run(asyncio.wait_for(engine.run(), 60))
    _wait_zombies(runner)
    assert stream.rows_out == count and stream.output.dropped_rows == count
    assert stream.errors == 1 and stream.input.redeliveries == 1
    assert (runner.deadline_misses, runner.rebuilds, runner.ooms) == (1, 1, 1)
    assert runner.bucket_cap < 64 and runner.health.state == "healthy"
    # every probe that ended passed (a tick in flight at close is cancelled)
    assert mon.results["ok"] >= 1
    assert mon.results["mismatch"] == mon.results["error"] == mon.results["digest_mismatch"] == 0
