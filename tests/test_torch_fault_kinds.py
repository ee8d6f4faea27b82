"""The remaining fault kinds, the retry and breaker configs, and the
delivery keys of the config, against the JAX package's: each scenario runs
through both packages' streams (``thread_num: 1``) and the observations are
held equal."""

import asyncio
import json

import pytest

from tests.test_torch_delivery import (
    JAX,
    PKGS,
    PORT,
    both,
    collect,
    counters,
    payloads_of,
    run,
    sched,
    uname,
)


def _stream_of(pkg, messages, *, in_faults=(), proc_faults=(), out_faults=(), **kw):
    inp = pkg.wrappers.FaultInjectingInput(
        pkg.MemoryInput(messages),
        sched(pkg, [dict(f) for f in in_faults], "INPUT_KINDS", "input"),
        redeliver_unacked=kw.pop("redeliver", False))
    proc = pkg.wrappers.FaultInjectingProcessor(
        None, sched(pkg, [dict(f) for f in proc_faults], "PROCESSOR_KINDS", "processor"))
    sink = collect(pkg)
    out = pkg.wrappers.FaultInjectingOutput(
        sink, sched(pkg, [dict(f) for f in out_faults], "OUTPUT_KINDS", "output"))
    stream = pkg.Stream(inp, pkg.Pipeline([proc]), out, thread_num=1, name=uname("kinds"),
                        output_retry=pkg.retry.RetryConfig(max_attempts=2, initial_delay_ms=1),
                        **kw)
    return stream, inp, sink


def _burst(pkg) -> dict:
    stream, inp, sink = _stream_of(pkg, [b"a", b"b"], redeliver=True,
                                   in_faults=[{"kind": "burst", "every": 1, "times": 0,
                                               "factor": 3}])
    run(stream)
    return {"delivered": payloads_of(sink), "outstanding": inp._outstanding,
            **counters(pkg, stream)}


def test_burst_delivers_each_read_factor_times():
    got = both(_burst)
    assert sorted(got["delivered"]) == [b"a"] * 3 + [b"b"] * 3
    assert got["outstanding"] == 0 and got["rows_out"] == 6


def _read_error(pkg) -> dict:
    stream, inp, sink = _stream_of(pkg, [b"a", b"b", b"c"],
                                   in_faults=[{"kind": "error", "at": 2}])
    run(stream)
    return {"delivered": payloads_of(sink), "reads": inp._reads}


def test_input_error_replaces_one_read_and_loses_nothing():
    """An injected ReadError is logged; the stream reads on after 100 ms."""
    got = both(_read_error)
    assert got == {"delivered": [b"a", b"b", b"c"], "reads": 5}


def _crash(pkg, family: str) -> dict:
    key = {"input": "in_faults", "processor": "proc_faults", "output": "out_faults"}[family]
    stream, _, sink = _stream_of(pkg, [b"a", b"b", b"c"], **{key: [{"kind": "crash", "at": 2}]})
    try:
        run(stream)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    return {"raised": raised, "delivered": payloads_of(sink), **counters(pkg, stream)}


@pytest.mark.parametrize("family,raised,delivered", [
    ("input", "chaos: injected crash", [b"a"]),
    ("processor", None, [b"a", b"c"]),
    ("output", None, [b"a", b"b", b"c"]),
])
def test_crash_faults_behave_as_jax_s(family, raised, delivered):
    """A crash raises a plain RuntimeError: from the input it escapes the
    stream's run (after every stage closed); a processor's is contained as a
    processing error, an output's retried like any write failure."""
    got = both(_crash, family)
    assert got["raised"] == raised and got["delivered"] == delivered


def test_crashed_stream_ends_and_the_engine_returns():
    """With no ``restart`` key a crashed stream ends, as the JAX engine's
    does, and the engine itself finishes."""
    from arkflow_tpu_torch.config import EngineConfig
    from arkflow_tpu_torch.runtime.engine import Engine

    crash = {"kind": "crash", "at": 3}
    engine = Engine(EngineConfig.from_mapping({"streams": [{
        "name": "crash", "input": {"type": "fault", "faults": [crash],
                                   "inner": {"type": "memory", "messages": ["c0", "c1", "c2"]}},
        "pipeline": {"thread_num": 1, "processors": []}, "output": {"type": "drop"}}]}))
    asyncio.run(asyncio.wait_for(engine.run(), 10))
    assert crash["_state"]["fired"] == 1 and engine.streams[0].rows_out == 2


def _latency(pkg) -> dict:
    stream, _, sink = _stream_of(pkg, [b"a", b"b"],
                                 proc_faults=[{"kind": "latency", "every": 1,
                                               "duration": "2ms"}],
                                 out_faults=[{"kind": "latency", "at": 1, "duration": "1ms"},
                                             {"kind": "error", "match": "b", "times": 1}])
    loop = asyncio.new_event_loop()
    try:
        t0 = loop.time()
        loop.run_until_complete(asyncio.wait_for(stream.run(asyncio.Event()), 10))
        slow = loop.time() - t0 >= 0.005
    finally:
        loop.close()
    return {"delivered": payloads_of(sink), "slow": slow, **counters(pkg, stream)}


def test_latency_and_matched_output_faults():
    got = both(_latency)
    assert got["delivered"] == [b"a", b"b"] and got["slow"]
    assert got["output_retries"] == 1 and got["write_errors"] == 0


@pytest.mark.parametrize("kind", ["net_delay", "net_stall", "net_blackhole", "net_reset",
                                  "net_corrupt"])
def test_net_kinds_are_not_ported(kind):
    with pytest.raises(PORT.ConfigError, match="not yet ported"):
        PORT.build_component("processor", {"type": "fault", "faults": [{"kind": kind, "at": 1}]},
                             PORT.base.Resource())


@pytest.mark.parametrize("patch", [
    {"temporary": [{"name": "t", "type": "memory"}]},
    {"pipeline": {"processors": [], "process_pool": 2}},
    {"buffer": {"type": "tumbling_window", "interval": "1s", "query": "SELECT * FROM flow"}},
    {"input": {"type": "memory", "messages": ["a"], "tenants": 2}},
    {"pipeline": {"processors": [], "ingest_shards": 2}},
])
def test_unported_stream_keys_still_raise(patch):
    from arkflow_tpu_torch.config import StreamConfig
    from arkflow_tpu_torch.runtime.stream import build_stream

    raw = {"input": {"type": "memory", "messages": ["a"]}, "output": {"type": "drop"}, **patch}
    with pytest.raises(PORT.ConfigError, match="not yet ported"):
        build_stream(StreamConfig.from_mapping(raw))


# -- retry and breaker ----------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    None, {}, {"max_attempts": 5}, {"initial_delay_ms": 10, "max_delay_ms": 40},
    {"initial_delay_ms": 0, "backoff_multiplier": 3.0, "max_delay_ms": 9000},
])
def test_retry_config_delays_equal_jax(cfg):
    got = {}
    for pkg in PKGS:
        rc = pkg.retry.RetryConfig.from_config(cfg)
        got[pkg.name] = (rc.max_attempts, [rc.delay_s(i) for i in (0, 1, 2, 5, 70, 10_000)])
    assert got["port"] == got["jax"]


def _message(pkg, fn, *args) -> str:
    with pytest.raises(pkg.ConfigError) as info:
        fn(pkg)(*args)
    return str(info.value)


@pytest.mark.parametrize("cfg", [
    {"max_attempts": 0}, {"initial_delay_ms": 10, "max_delay_ms": 5},
    {"initial_delay_ms": -1}, {"backoff_multiplier": 0.5}, {"jitter": 1.5}, {"jitter": -0.1},
])
def test_retry_config_refusals_equal_jax(cfg):
    def fn(pkg):
        return pkg.retry.RetryConfig.from_config

    assert _message(PORT, fn, cfg) == _message(JAX, fn, cfg)


@pytest.mark.parametrize("cfg", [{"failure_threshold": 0}, "yes", 3, ["x"]])
def test_breaker_config_refusals_equal_jax(cfg):
    def fn(pkg):
        return pkg.circuit_breaker.CircuitBreakerConfig.from_config

    assert _message(PORT, fn, cfg) == _message(JAX, fn, cfg)


@pytest.mark.parametrize("cfg", [None, False, True, {}, {"failure_threshold": 2},
                                 {"reset_timeout": "250ms"}, {"reset_timeout": "1m 30s"}])
def test_breaker_config_parses_as_jax(cfg):
    got = {}
    for pkg in PKGS:
        c = pkg.circuit_breaker.CircuitBreakerConfig.from_config(cfg)
        got[pkg.name] = None if c is None else (c.failure_threshold, c.reset_timeout_s)
    assert got["port"] == got["jax"]


def test_breaker_walks_its_states_as_jax_s():
    async def walk(pkg) -> list:
        br = pkg.circuit_breaker.CircuitBreaker(
            pkg.circuit_breaker.CircuitBreakerConfig(failure_threshold=2, reset_timeout_s=0.01))
        seen = []
        for outcome in (False, False, False, True, False, False, True):
            await br.acquire()
            (br.record_success if outcome else br.record_failure)()
            seen.append(br.state)
        return seen + br.history

    got = {pkg.name: asyncio.run(walk(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert PORT.circuit_breaker.CircuitBreaker(
        PORT.circuit_breaker.CircuitBreakerConfig()).trips == 0


def test_retry_with_backoff_fails_fast_on_config_errors_and_counts_retries():
    async def go(pkg):
        calls, retries = [], []

        async def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("transient")
            return "ok"

        cfg = pkg.retry.RetryConfig(max_attempts=3, initial_delay_ms=1)
        out = await pkg.retry.retry_with_backoff(flaky, cfg, on_retry=lambda: retries.append(1))

        async def bad():
            calls.append("bad")
            raise pkg.ConfigError("bad key")

        with pytest.raises(pkg.ConfigError):
            await pkg.retry.retry_with_backoff(bad, cfg)

        async def dead():
            raise RuntimeError("down")

        with pytest.raises(RuntimeError, match="down"):
            await pkg.retry.retry_with_backoff(dead, pkg.retry.RetryConfig(
                max_attempts=2, initial_delay_ms=1))
        return out, len(retries), calls.count("bad")

    got = {pkg.name: asyncio.run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"] == ("ok", 2, 1)


# -- the config's delivery keys -------------------------------------------------


def _delivery_cfg() -> dict:
    return {"input": {"type": "memory", "messages": ["a"],
                      "reconnect": {"initial_delay_ms": 3, "max_delay_ms": 30}},
            "output": {"type": "drop", "retry": {"max_attempts": 6, "jitter": 0.1},
                       "circuit_breaker": {"failure_threshold": 2, "reset_timeout": "20ms"}},
            "error_output": {"type": "drop", "circuit_breaker": True,
                             "retry": {"max_attempts": 2}},
            "pipeline": {"thread_num": 1, "max_delivery_attempts": 4}}


def test_delivery_keys_parse_as_jax():
    got = {}
    for pkg in PKGS:
        c = pkg.config.StreamConfig.from_mapping(_delivery_cfg())
        got[pkg.name] = (c.output_retry, c.output_circuit_breaker, c.error_output_retry,
                         c.error_output_circuit_breaker, c.input_reconnect,
                         c.error_output["type"], c.pipeline.max_delivery_attempts)
    flat = {k: tuple(getattr(x, "__dict__", x) for x in v) for k, v in got.items()}
    assert flat["port"] == flat["jax"]
    port = PORT.config.StreamConfig.from_mapping(_delivery_cfg())
    # the stream consumes these keys: the component builders never see them
    assert "reconnect" not in port.input and "retry" not in port.output
    assert "circuit_breaker" not in port.error_output


def test_error_output_is_validated_built_and_closed_before_output(tmp_path):
    from arkflow_tpu_torch.config import EngineConfig
    from arkflow_tpu_torch.runtime import cli
    from arkflow_tpu_torch.runtime.stream import build_stream

    cfg = {"streams": [_delivery_cfg()]}
    path = tmp_path / "s.json"
    path.write_text(json.dumps(cfg))
    assert cli.main(["--config", str(path), "--validate"]) == 0
    cfg["streams"][0]["error_output"]["type"] = "nowhere"
    path.write_text(json.dumps(cfg))
    assert cli.main(["--config", str(path), "--validate"]) == 2
    cfg["streams"][0]["error_output"] = {"type": "drop", "codec": "json"}
    assert EngineConfig.from_mapping(cfg).validate_components()[0].endswith(
        "is not yet ported to arkflow_tpu_torch")

    order = []
    stream = build_stream(PORT.config.StreamConfig.from_mapping(_delivery_cfg()))
    for name in ("output", "error_output"):
        comp = getattr(stream, name)

        async def close(name=name):
            order.append(name)

        comp.close = close
    run(stream)
    assert order == ["error_output", "output"]
    assert stream.error_output.dropped_batches == 0 and stream.output.dropped_rows == 1


def test_memory_input_equals_jax_s():
    async def read_all(pkg) -> list:
        inp = pkg.MemoryInput([b"a", b"bc"])
        await inp.connect()
        out = []
        while True:
            try:
                batch, _ = await inp.read()
            except pkg.EndOfInput:
                return out
            out.append((batch.num_rows, batch.to_binary(), batch.get_meta("__meta_source")))

    got = {pkg.name: asyncio.run(read_all(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"] == [(1, [b"a"], "memory"), (1, [b"bc"], "memory")]
    built = PORT.build_component("input", {"type": "memory", "messages": ["x", {"k": 1}, b"y"]},
                                 PORT.base.Resource())
    assert built._initial == [b"x", b'{"k": 1}', b"y"]
    with pytest.raises(PORT.ConfigError, match="requires 'messages'"):
        PORT.build_component("input", {"type": "memory"}, PORT.base.Resource())
