"""The engine's restart policies against the JAX engine's: the stream's
``restart`` key, the supervision loop (a fresh stream from config on every
attempt, the budget restored after ``reset_after``, a failed rebuild
retried), ``/health``'s ``restarts`` and ``restart_budget_remaining``, and
a crashed ``gpu_inference`` stream's device state released before the
rebuild.

The cases of ``tests/test_engine.py`` and ``tests/test_faults.py`` run once
through each package's engine (JAX's with its health server off), with
``Stream.run`` or ``build_stream`` patched as the JAX tests patch them: the
crash and build counts are held equal, and to the JAX tests' own."""

import asyncio
import json

import numpy as np
import pytest

from tests.test_torch_connectors import http_call
from tests.test_torch_overload import JAX, PKGS, PORT, both, collect, run, uname
from tests.test_tpu_layer import TINY_BERT


def engine_of(pkg, stream: dict, health: bool = False):
    hc = ({"enabled": True, "host": "127.0.0.1", "port": 0} if health and pkg is PORT
          else {"enabled": False})
    return pkg.engine_mod.Engine(pkg.config.EngineConfig.from_mapping(
        {"streams": [stream], "health_check": hc}))


def generate_stream(name: str, restart=None) -> dict:
    s = {"name": uname(name), "input": {"type": "generate", "payload": "x", "interval": 0,
                                        "batch_size": 1, "count": 1},
         "pipeline": {"thread_num": 1, "processors": []}, "output": {"type": "drop"}}
    if restart is not None:
        s["restart"] = restart
    return s


def crash_first(monkeypatch, pkg, n: int) -> dict:
    """``Stream.run`` raises on its first ``n`` calls, then runs."""
    real = pkg.engine_mod.Stream.run
    crashes = {"n": 0}

    async def flaky_run(self, cancel):
        if crashes["n"] < n:
            crashes["n"] += 1
            raise RuntimeError("injected stream crash")
        await real(self, cancel)

    monkeypatch.setattr(pkg.engine_mod.Stream, "run", flaky_run)
    return crashes


def flaky_builds(monkeypatch, pkg, fail_at: int) -> dict:
    """``build_stream`` raises on its ``fail_at``-th call (the first is the
    engine's initial build)."""
    real = pkg.engine_mod.build_stream
    builds = {"n": 0}

    def flaky(cfg, name=None):
        builds["n"] += 1
        if builds["n"] == fail_at:
            raise RuntimeError("injected rebuild failure")
        return real(cfg, name=name)

    monkeypatch.setattr(pkg.engine_mod, "build_stream", flaky)
    return builds


@pytest.mark.parametrize("m", [
    None, False, {}, {"max_retries": 5, "backoff": "10ms", "reset_after": "1h"},
    {"max_retries": "2", "backoff": 1}, {"max_retries": -1}, {"backoff": "-1s"},
    {"max_retries": "x"}, {"backoff": "soon"}, "always", 3,
], ids=str)
def test_restart_config_matches_jax(m):
    def go(pkg):
        raw = {"input": {"type": "memory", "messages": []}, "output": {"type": "drop"}}
        if m is not None:
            raw["restart"] = m
        try:
            return ("ok", pkg.config.StreamConfig.from_mapping(raw).restart)
        except pkg.ConfigError as e:
            return ("error", str(e))

    got = both(go)
    if m == {}:
        assert got == ("ok", {"max_retries": 3, "backoff_s": 5.0, "reset_after_s": 300.0})


def test_stream_restart_policy_rebuilds_crashed_stream(monkeypatch):
    def go(pkg):
        crashes = crash_first(monkeypatch, pkg, 2)
        engine = engine_of(pkg, generate_stream("flaky", {"max_retries": 3, "backoff": "10ms"}))
        run(engine.run(), timeout=30)
        return crashes["n"], engine.stream_health()[engine.streams[0].name]["restarts"]

    assert both(go) == (2, 2)


def test_restart_rebuild_failure_does_not_kill_engine(monkeypatch):
    def go(pkg):
        crashes = {"n": 0}

        async def crash_run(self, cancel):
            crashes["n"] += 1
            raise RuntimeError("injected stream crash")

        monkeypatch.setattr(pkg.engine_mod.Stream, "run", crash_run)
        builds = flaky_builds(monkeypatch, pkg, 2)
        engine = engine_of(pkg, generate_stream("flaky", {"max_retries": 2, "backoff": "10ms"}))
        run(engine.run(), timeout=15)
        health = engine.stream_health()[engine.streams[0].name]
        return builds["n"], crashes["n"], health["restarts"], health["restart_budget_remaining"]

    assert both(go) == (3, 2, 2, 0)


def test_restart_budget_resets_after_long_run(monkeypatch):
    def go(pkg):
        crashes = crash_first(monkeypatch, pkg, 3)
        engine = engine_of(pkg, generate_stream(
            "forgiven", {"max_retries": 1, "backoff": "10ms", "reset_after": "0s"}))
        run(engine.run(), timeout=30)
        return crashes["n"]

    assert both(go) == 3


def test_restart_budget_not_reset_for_short_runs(monkeypatch):
    def go(pkg):
        crashes = {"n": 0}

        async def crash_run(self, cancel):
            crashes["n"] += 1
            raise RuntimeError("injected stream crash")

        monkeypatch.setattr(pkg.engine_mod.Stream, "run", crash_run)
        engine = engine_of(pkg, generate_stream(
            "exhausted", {"max_retries": 1, "backoff": "10ms", "reset_after": "1h"}))
        run(engine.run(), timeout=30)
        return crashes["n"], engine.stream_health()[engine.streams[0].name]

    assert both(go) == (2, {"restarts": 1, "restart_budget_remaining": 0})


def test_restart_rebuild_failure_then_recovery(monkeypatch):
    def go(pkg):
        crash_first(monkeypatch, pkg, 1)
        builds = flaky_builds(monkeypatch, pkg, 2)
        engine = engine_of(pkg, {"name": uname("recovers"),
                                 "input": {"type": "memory", "messages": ["a", "b"]},
                                 "pipeline": {"thread_num": 1, "processors": []},
                                 "output": {"type": "drop"},
                                 "restart": {"max_retries": 3, "backoff": "10ms"}})
        run(engine.run(), timeout=30)
        return builds["n"], engine.streams[0].m_rows_out.value

    assert both(go) == (3, 2.0)


def test_stream_without_restart_policy_stops_on_crash(monkeypatch):
    def go(pkg):
        calls = {"n": 0}

        async def crash_run(self, cancel):
            calls["n"] += 1
            raise RuntimeError("injected")

        monkeypatch.setattr(pkg.engine_mod.Stream, "run", crash_run)
        engine = engine_of(pkg, generate_stream("fragile"))
        run(engine.run(), timeout=10)
        return calls["n"], engine.stream_health()[engine.streams[0].name]

    assert both(go) == (1, {"restarts": 0, "restart_budget_remaining": None})


def test_restart_backoff_is_cancel_aware(monkeypatch):
    """A shutdown during the backoff ends the supervision at once: no
    rebuild follows."""
    def go(pkg):
        crashes = {"n": 0}

        async def crash_run(self, cancel):
            crashes["n"] += 1
            raise RuntimeError("injected")

        monkeypatch.setattr(pkg.engine_mod.Stream, "run", crash_run)
        builds = flaky_builds(monkeypatch, pkg, 0)
        engine = engine_of(pkg, generate_stream("cancel", {"max_retries": 3, "backoff": "30s"}))

        async def drive():
            task = asyncio.ensure_future(engine.run())
            await asyncio.sleep(0.2)
            engine.shutdown()
            await asyncio.wait_for(task, 5)

        run(drive(), timeout=10)
        return crashes["n"], builds["n"]

    assert both(go) == (1, 1)


def test_crash_at_batch_n_with_restart_policy():
    """The crash fault escapes the contained error paths, the policy
    rebuilds the stream, and the fault's state in the config dict keeps it
    one-shot across the rebuild: the replayed stream completes."""
    def go(pkg):
        crash = {"kind": "crash", "at": 3}
        engine = engine_of(pkg, {
            "name": uname("chaos-crash"),
            "input": {"type": "fault", "inner": {"type": "memory",
                                                 "messages": ["c0", "c1", "c2", "c3"]},
                      "faults": [crash]},
            "pipeline": {"thread_num": 1, "processors": []}, "output": {"type": "drop"},
            "restart": {"max_retries": 3, "backoff": "10ms"}})
        run(engine.run(), timeout=30)
        live = engine.streams[0]
        return (crash["_state"]["fired"], live.m_rows_out.value,
                engine.stream_health()[live.name])

    fired, rows_out, health = both(go)
    assert fired == 1 and rows_out == 6.0  # two before the crash, four replayed
    assert health == {"restarts": 1, "restart_budget_remaining": 2}


def test_rebuilt_stream_keeps_its_metric_series_and_health_over_http():
    """The rebuilt stream's series are the crashed one's (same name and
    labels), ``/health`` on port 0 shows ``restarts`` 1 and
    ``restart_budget_remaining`` 2 while the rebuilt stream runs, and the
    engine records the rebuild's milliseconds."""
    crash = {"kind": "crash", "at": 3}
    name = uname("health-restart")
    engine = engine_of(PORT, {
        "name": name,
        "input": {"type": "fault", "faults": [crash], "inner": {
            "type": "generate", "payload": "x", "interval": "5ms", "batch_size": 1,
            "count": 60}},
        "pipeline": {"thread_num": 1, "processors": []}, "output": {"type": "drop"},
        "restart": {"max_retries": 3, "backoff": "10ms"}}, health=True)
    first = engine.build()[0]

    async def go():
        task = asyncio.ensure_future(engine.run())
        body = None
        for _ in range(200):
            await asyncio.sleep(0.02)
            if engine.health_port and engine.streams[0] is not first:
                status, _, raw = await http_call(engine.health_port, "GET", "/health")
                body = json.loads(raw)["stream_health"][name]
                break
        await asyncio.wait_for(task, 20)
        return body

    body = run(go(), timeout=30)
    live = engine.streams[0]
    assert body is not None and body["restarts"] == 1 and body["restart_budget_remaining"] == 2
    assert live is not first and live.m_rows_out is first.m_rows_out
    assert live.m_rows_out.value == 62.0  # 2 before the crash, 60 after
    assert len(engine.rebuild_ms[name]) == 1 and engine.rebuild_ms[name][0] > 0


def _bert_restart_stream(name: str, crash: bool) -> dict:
    faults = [{"kind": "crash", "at": 3}] if crash else []
    return {"name": name,
            "input": {"type": "fault", "faults": faults, "inner": {
                "type": "memory", "messages": [f"text number {i} of the restart run"
                                               for i in range(12)]}},
            "pipeline": {"thread_num": 1, "processors": [{
                "type": "gpu_inference", "model": "bert_classifier", "model_config": TINY_BERT,
                "max_seq": 32, "batch_buckets": [1], "seq_buckets": [32], "device": "cpu",
                "warmup": True, "outputs": ["label", "logits"]}]},
            "output": {"type": "drop"},
            "restart": {"max_retries": 3, "backoff": "10ms"}}


def test_gpu_inference_restart_releases_the_crashed_runner_and_matches_a_clean_run():
    """A ``gpu_inference`` stream (TINY_BERT on the CPU) crashing at its
    third read: the crash fires once, the crashed stream's runner is
    released (its weights and graphs gone) before the rebuild, every text is
    delivered, and each text's outputs from the rebuilt stream equal a
    crash-free run's bit for bit (same seed)."""
    def run_engine(crash: bool):
        raw = _bert_restart_stream(uname("bert-restart"), crash)
        engine = engine_of(PORT, raw)
        first = engine.build()[0]
        sinks = []
        real_build = PORT.engine_mod.build_stream

        def rebuilt(cfg, name=None):
            s = real_build(cfg, name=name)
            s.output = collect(PORT)
            sinks.append(s.output)
            return s

        first.output = collect(PORT)
        sinks.append(first.output)
        PORT.engine_mod.build_stream = rebuilt
        try:
            run(engine.run(), timeout=120)
        finally:
            PORT.engine_mod.build_stream = real_build
        out = {}
        for sink in sinks:
            for b in sink.batches:
                d = b.to_pydict()
                for text, label, logits in zip(b.to_binary(), d["label"], d["logits"]):
                    out[text] = (label, np.asarray(logits).tobytes())
        return engine, first, out, raw

    engine, first, crashed_out, raw = run_engine(crash=True)
    _, _, clean_out, _ = run_engine(crash=False)
    assert raw["input"]["faults"][0]["_state"]["fired"] == 1
    assert engine.stream_health()[raw["name"]]["restarts"] == 1
    assert first.pipeline.processors[0].runner.params == {}
    assert len(first.pipeline.processors[0].runner._compiled) == 0
    live = engine.streams[0].pipeline.processors[0].runner
    assert live.params and live.device_steps >= 12
    assert set(crashed_out) == set(clean_out) and len(clean_out) == 12
    assert crashed_out == clean_out


TINY_DECODER = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, ffn=96, max_seq=64)


def _generate_restart_stream(name: str, crash: bool, serving: str) -> dict:
    faults = [{"kind": "crash", "at": 3}] if crash else []
    proc = {"type": "gpu_generate", "model": "decoder_lm", "model_config": TINY_DECODER,
            "max_input": 16, "max_new_tokens": 4, "device": "cpu", "serving": serving}
    if serving == "continuous":
        proc.update(slots=2, page_size=8)
    else:
        proc.update(batch_buckets=[1], seq_buckets=[16])
    return {"name": name,
            "input": {"type": "fault", "faults": faults, "inner": {
                "type": "memory", "messages": [f"prompt {i} of the generate restart"
                                               for i in range(8)]}},
            "pipeline": {"thread_num": 1, "processors": [proc]},
            "output": {"type": "drop"},
            "restart": {"max_retries": 3, "backoff": "10ms"}}


@pytest.mark.parametrize("serving", ["continuous", "batch"])
def test_gpu_generate_restart_releases_the_crashed_server_and_matches_a_clean_run(serving):
    """A ``gpu_generate`` stream (the tiny decoder on the CPU, each serving
    mode) crashing at its third read: the crashed stream's server or
    generator is released before the rebuild (its graphs, KV pools or
    caches and weights gone, the processor's tree dropped), every prompt is
    delivered, and each prompt's text from the rebuilt stream equals a
    crash-free run's (greedy, same seed)."""
    def run_engine(crash: bool):
        raw = _generate_restart_stream(uname("gen-restart"), crash, serving)
        engine = engine_of(PORT, raw)
        first = engine.build()[0]
        sinks = []
        real_build = PORT.engine_mod.build_stream

        def rebuilt(cfg, name=None):
            s = real_build(cfg, name=name)
            s.output = collect(PORT)
            sinks.append(s.output)
            return s

        first.output = collect(PORT)
        sinks.append(first.output)
        PORT.engine_mod.build_stream = rebuilt
        try:
            run(engine.run(), timeout=60)
        finally:
            PORT.engine_mod.build_stream = real_build
        out = {}
        for sink in sinks:
            for b in sink.batches:
                for text, gen in zip(b.to_binary(), b.to_binary("generated")):
                    out[text] = gen
        return engine, first, out, raw

    engine, first, crashed_out, raw = run_engine(crash=True)
    _, _, clean_out, _ = run_engine(crash=False)
    assert raw["input"]["faults"][0]["_state"]["fired"] == 1
    assert engine.stream_health()[raw["name"]]["restarts"] == 1
    proc = first.pipeline.processors[0]
    part = proc.server if serving == "continuous" else proc.generator
    assert part.params == {} and proc.params == {} and len(part._compiled) == 0
    if serving == "continuous":
        assert part.k_pages is None and part.v_pages is None and not part._host.by_key
    else:
        assert not part._spaces
    live = engine.streams[0].pipeline.processors[0]
    assert live.params and live.tokens > 0
    assert set(crashed_out) == set(clean_out) and len(clean_out) == 8
    assert crashed_out == clean_out


def test_a_release_that_raises_does_not_end_supervision(monkeypatch):
    """``Stream.release`` raising after a crash is logged and the restart
    goes on: the rebuilt stream delivers, as JAX's loop goes on after a
    crash (the JAX engine has no release step)."""
    crashes = crash_first(monkeypatch, PORT, 1)

    def bad_release(self):
        raise RuntimeError("injected release failure")

    monkeypatch.setattr(PORT.engine_mod.Stream, "release", bad_release)
    raw = generate_stream("release-raises", {"max_retries": 2, "backoff": "10ms"})
    engine = engine_of(PORT, raw)
    run(engine.run(), timeout=10)
    assert crashes["n"] == 1
    assert engine.stream_health()[raw["name"]]["restarts"] == 1
