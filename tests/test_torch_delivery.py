"""The delivery plane against the JAX package's: ``error_output`` with
quarantine, the coalescer's suspect-solo poison isolation, output retry and
circuit breaker, input reconnect and the fault kinds that drive them.

Every scenario of ``tests/test_faults.py``, ``tests/test_runtime.py`` (the
error-output, reconnect and write-failure tests) and ``tests/test_infeed.py``
(the coalesced quarantine and poison regrouping) runs once through each
package's own stream, on the same batches, faults and seeds, with
``thread_num: 1``: the delivered and quarantined payloads, the quarantine
tags, the counters and the input's outstanding deliveries are held equal,
and to the JAX test's own assertions."""

import asyncio
import json
import types
import uuid
from pathlib import Path

import jax
import numpy as np
import pytest

from arkflow_tpu_torch.components import ensure_plugins_loaded
from tests.test_tpu_layer import TINY_BERT

ensure_plugins_loaded()

ROOT = Path(__file__).resolve().parent.parent
LOGIT_ATOL = 1.0 / 64
TIE_MARGIN = 0.05
COUNTERS = ("errors", "write_errors", "output_retries", "quarantined_batches",
            "quarantine_drops", "ack_failures", "rows_out")
#: the JAX stream's metric behind each of the port's counters
JAX_METRICS = {"errors": "m_errors", "write_errors": "m_write_errors",
               "output_retries": "m_out_retries", "quarantined_batches": "m_quarantined",
               "quarantine_drops": "m_quarantine_drops", "ack_failures": "m_ack_failures",
               "rows_out": "m_rows_out"}


def _jax_pkg():
    from arkflow_tpu import batch, config
    from arkflow_tpu.components import Ack, NoopAck, base
    from arkflow_tpu.components.registry import build_component
    from arkflow_tpu.errors import ConfigError, Disconnection, EndOfInput
    from arkflow_tpu.plugins.buffer.memory import MemoryBuffer
    from arkflow_tpu.plugins.fault import schedule, wrappers
    from arkflow_tpu.plugins.input.memory import MemoryInput
    from arkflow_tpu.plugins.output.drop import DropOutput
    from arkflow_tpu.runtime import Pipeline, Stream, build_stream
    from arkflow_tpu.runtime import stream as stream_mod
    from arkflow_tpu.tpu import bucketing
    from arkflow_tpu.utils import circuit_breaker, retry

    return types.SimpleNamespace(name="jax", **locals())


def _port_pkg():
    from arkflow_tpu_torch import batch, config
    from arkflow_tpu_torch.components import Ack, NoopAck, base
    from arkflow_tpu_torch.components.registry import build_component
    from arkflow_tpu_torch.errors import ConfigError, Disconnection, EndOfInput
    from arkflow_tpu_torch.plugins.buffer.memory import MemoryBuffer
    from arkflow_tpu_torch.plugins.fault import schedule, wrappers
    from arkflow_tpu_torch.plugins.input.memory import MemoryInput
    from arkflow_tpu_torch.plugins.output.drop import DropOutput
    from arkflow_tpu_torch.runtime import stream as stream_mod
    from arkflow_tpu_torch.runtime.pipeline import Pipeline
    from arkflow_tpu_torch.runtime.stream import Stream, build_stream
    from arkflow_tpu_torch.tpu import bucketing
    from arkflow_tpu_torch.utils import circuit_breaker, retry

    return types.SimpleNamespace(name="port", **locals())


JAX, PORT = _jax_pkg(), _port_pkg()
PKGS = (JAX, PORT)


# -- harness ------------------------------------------------------------------


def uname(base: str) -> str:
    """JAX streams register their metrics by stream name in one process-wide
    registry: every JAX stream of these tests gets a name of its own."""
    return f"{base}-{uuid.uuid4().hex[:8]}"


def collect(pkg):
    class Collect(pkg.DropOutput):
        def __init__(self):
            super().__init__()
            self.batches = []

        async def write(self, batch) -> None:
            await super().write(batch)
            self.batches.append(batch)

    return Collect()


def payloads_of(sink) -> list[bytes]:
    return [p for b in sink.batches for p in b.to_binary()]


def sched(pkg, faults: list, kinds: str, family: str, seed: int = 7):
    return pkg.schedule.FaultSchedule(
        pkg.schedule.parse_faults(faults, getattr(pkg.wrappers, kinds), family), seed=seed)


def retry_cfg(pkg, **kw):
    return pkg.retry.RetryConfig(**kw)


def fast_retry(pkg):
    return retry_cfg(pkg, max_attempts=3, initial_delay_ms=1, max_delay_ms=5)


def fast_reconnect(pkg):
    return retry_cfg(pkg, max_attempts=3, initial_delay_ms=1, max_delay_ms=10)


def counters(pkg, stream) -> dict:
    if pkg is JAX:
        return {k: int(getattr(stream, m).value) for k, m in JAX_METRICS.items()}
    return {k: getattr(stream, k) for k in COUNTERS}


def quarantine_tags(sink) -> list[tuple]:
    return [(b.num_rows, b.get_meta("__meta_ext_error"),
             b.get_meta("__meta_ext_delivery_attempts")) for b in sink.batches]


def run(stream, timeout: float = 30) -> None:
    asyncio.run(asyncio.wait_for(stream.run(asyncio.Event()), timeout=timeout))


def chaos_input(pkg, messages, faults, acked, violations, sinks, redeliver=True):
    """A fault-wrapped memory input whose acks record their order: an ack
    that fires before its payload reached a sink is a violation."""

    class RecordingAck(pkg.Ack):
        def __init__(self, payload: bytes):
            self.payload = payload

        async def ack(self) -> None:
            delivered = {p for s in sinks for p in payloads_of(s)}
            if self.payload not in delivered:
                violations.append(self.payload)
            acked.append(self.payload)

    class Src(pkg.MemoryInput):
        async def read(self):
            batch, _ = await super().read()
            return batch, RecordingAck(batch.to_binary()[0])

    return pkg.wrappers.FaultInjectingInput(
        Src(messages), sched(pkg, faults, "INPUT_KINDS", "input"), redeliver_unacked=redeliver)


def both(scenario, *args, **kwargs) -> dict:
    """Run a scenario in both packages; the observations must be equal."""
    got = {pkg.name: scenario(pkg, *args, **kwargs) for pkg in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


# -- tests/test_faults.py -----------------------------------------------------


def _e2e(pkg) -> dict:
    messages = [b"m0", b"m1", b"m2", b"poison", b"m4", b"m5", b"m6", b"m7"]
    acked, violations = [], []
    sink, err_sink = collect(pkg), collect(pkg)
    inp = chaos_input(pkg, messages, [{"kind": "disconnect", "at": 5},
                                      {"kind": "reconnect_fail", "at": 1}],
                      acked, violations, [sink, err_sink])
    proc = pkg.wrappers.FaultInjectingProcessor(
        None, sched(pkg, [{"kind": "error", "match": "poison"}], "PROCESSOR_KINDS", "processor"))
    out = pkg.wrappers.FaultInjectingOutput(
        sink, sched(pkg, [{"kind": "error", "at": 2, "times": 2}], "OUTPUT_KINDS", "output"))
    stream = pkg.Stream(inp, pkg.Pipeline([proc]), out, error_output=err_sink, thread_num=1,
                        name=uname("chaos-e2e"), output_retry=fast_retry(pkg),
                        reconnect_retry=fast_reconnect(pkg), max_delivery_attempts=3)
    run(stream)
    return {"probes": inp._reconnects, "delivered": sorted(payloads_of(sink)),
            "quarantined": payloads_of(err_sink), "tags": quarantine_tags(err_sink),
            "violations": violations, "acked": sorted(acked), "outstanding": inp._outstanding,
            **counters(pkg, stream)}


def test_chaos_end_to_end_no_loss_invariants():
    """Transient write errors, a disconnect whose first reconnect probe
    fails and a poison row: every row written or quarantined exactly once
    within max_delivery_attempts, nothing acked before its write."""
    got = both(_e2e)
    ok = [b"m0", b"m1", b"m2", b"m4", b"m5", b"m6", b"m7"]
    assert got["probes"] == 2
    assert got["delivered"] == sorted(ok)
    assert got["quarantined"] == [b"poison"]
    assert got["tags"] == [(1, "chaos: injected error", "3")]
    assert got["violations"] == [] and got["acked"] == sorted(ok + [b"poison"])
    assert got["errors"] == 3 and got["output_retries"] == 2
    assert got["quarantined_batches"] == 1 and got["outstanding"] == 0


def _breaker(pkg) -> dict:
    messages = [b"a", b"b", b"c", b"d"]
    acked, violations = [], []
    sink = collect(pkg)
    inp = chaos_input(pkg, messages, [], acked, violations, [sink])
    out = pkg.wrappers.FaultInjectingOutput(
        sink, sched(pkg, [{"kind": "error", "at": 1, "times": 3}], "OUTPUT_KINDS", "output"))
    stream = pkg.Stream(inp, pkg.Pipeline([]), out, thread_num=1, name=uname("chaos-breaker"),
                        output_retry=fast_retry(pkg),
                        output_breaker=pkg.circuit_breaker.CircuitBreakerConfig(
                            failure_threshold=3, reset_timeout_s=0.05),
                        max_delivery_attempts=5)
    run(stream)
    br = stream._out_breaker
    trips = int(br.trip_counter.value) if pkg is JAX else br.trips
    return {"history": br.history, "trips": trips, "state": br.state,
            "delivered": sorted(payloads_of(sink)), "violations": violations,
            **counters(pkg, stream)}


def test_circuit_breaker_opens_probes_and_recovers():
    got = both(_breaker)
    assert got["history"] == ["closed", "open", "half_open", "closed"]
    assert got["trips"] == 1 and got["state"] == "closed"
    assert got["delivered"] == [b"a", b"b", b"c", b"d"] and got["violations"] == []
    assert got["write_errors"] == 1


def _errout_retry(pkg) -> dict:
    acked, violations = [], []
    err_inner = collect(pkg)
    err_out = pkg.wrappers.FaultInjectingOutput(
        err_inner, sched(pkg, [{"kind": "error", "at": 1, "times": 1}], "OUTPUT_KINDS", "output"))
    sink = collect(pkg)
    inp = chaos_input(pkg, [b"x"], [], acked, violations, [sink, err_inner])
    proc = pkg.wrappers.FaultInjectingProcessor(
        None, sched(pkg, [{"kind": "error", "every": 1}], "PROCESSOR_KINDS", "processor"))
    stream = pkg.Stream(inp, pkg.Pipeline([proc]), sink, error_output=err_out, thread_num=1,
                        name=uname("chaos-errout"), error_output_retry=fast_retry(pkg),
                        max_delivery_attempts=1)
    run(stream)
    return {"quarantined": payloads_of(err_inner), "acked": acked, "violations": violations,
            **counters(pkg, stream)}


def test_error_output_write_failure_retries_then_delivers():
    got = both(_errout_retry)
    assert got["quarantined"] == [b"x"] and got["acked"] == [b"x"]
    assert got["violations"] == [] and got["quarantined_batches"] == 1
    assert got["output_retries"] == 1


def _errout_dead(pkg) -> dict:
    acked = []
    err_out = pkg.wrappers.FaultInjectingOutput(
        collect(pkg), sched(pkg, [{"kind": "error", "every": 1}], "OUTPUT_KINDS", "output"))
    sink = collect(pkg)
    inp = chaos_input(pkg, [b"x", b"y"], [], acked, [], [sink])
    proc = pkg.wrappers.FaultInjectingProcessor(
        None, sched(pkg, [{"kind": "error", "match": "x"}], "PROCESSOR_KINDS", "processor"))
    stream = pkg.Stream(inp, pkg.Pipeline([proc]), sink, error_output=err_out, thread_num=1,
                        name=uname("chaos-errout-dead"), error_output_retry=fast_retry(pkg),
                        max_delivery_attempts=1)
    run(stream)
    return {"acked": sorted(acked), "delivered": payloads_of(sink), **counters(pkg, stream)}


def test_error_output_persistent_failure_acks_instead_of_wedging():
    got = both(_errout_dead)
    assert got["acked"] == [b"x", b"y"] and got["delivered"] == [b"y"]
    assert got["quarantine_drops"] == 1 and got["quarantined_batches"] == 0


def _ack_faults(pkg) -> dict:
    acked = []
    sink = collect(pkg)
    inp = chaos_input(pkg, [b"a", b"b", b"c"], [{"kind": "ack_fail", "at": 2},
                                                {"kind": "ack_dup", "at": 3}],
                      acked, [], [sink])
    stream = pkg.Stream(inp, pkg.Pipeline([]), sink, thread_num=1, name=uname("chaos-acks"),
                        output_retry=fast_retry(pkg))
    run(stream)
    return {"delivered": payloads_of(sink), "acked": sorted(acked),
            "outstanding": inp._outstanding, **counters(pkg, stream)}


def test_ack_faults_keep_at_least_once():
    """A failing ack redelivers (a duplicate, never a loss); a duplicated
    ack is harmless."""
    got = both(_ack_faults)
    assert set(got["delivered"]) == {b"a", b"b", b"c"}
    assert got["delivered"].count(b"b") == 2
    assert got["ack_failures"] == 1 and got["outstanding"] == 0
    assert got["acked"] == [b"a", b"b", b"c", b"c"]  # ack_dup acks its inner twice


def _reconnect_default(pkg) -> dict:
    sink = collect(pkg)
    inp = pkg.wrappers.FaultInjectingInput(
        pkg.MemoryInput([b"1", b"2", b"3"]),
        sched(pkg, [{"kind": "disconnect", "at": 2}], "INPUT_KINDS", "input"))
    stream = pkg.Stream(inp, pkg.Pipeline([]), sink, thread_num=1, name=uname("chaos-reconnect"))
    loop = asyncio.new_event_loop()
    try:
        t0 = loop.time()
        loop.run_until_complete(asyncio.wait_for(stream.run(asyncio.Event()), 10))
        seconds = loop.time() - t0
    finally:
        loop.close()
    return {"fast": seconds < 4.0, "delivered": sorted(payloads_of(sink)),
            "probes": inp._reconnects}


def test_reconnect_uses_backoff_not_fixed_5s():
    """The default reconnect schedule starts at 100 ms, not a fixed 5 s."""
    got = both(_reconnect_default)
    assert got == {"fast": True, "delivered": [b"1", b"2", b"3"], "probes": 1}


def _chaos_cfg() -> dict:
    return {
        "name": uname("chaos-cfg"),
        "input": {"type": "fault", "redeliver_unacked": True,
                  "reconnect": {"initial_delay_ms": 1, "max_delay_ms": 10},
                  "inner": {"type": "memory", "messages": ["k0", "k1", "poison", "k3", "k4"]},
                  "faults": [{"kind": "disconnect", "at": 2},
                             {"kind": "latency", "every": 2, "duration": "2ms"}]},
        "pipeline": {"thread_num": 1, "max_delivery_attempts": 2, "processors": [
            {"type": "fault", "faults": [{"kind": "error", "match": "poison"}]}]},
        "output": {"type": "fault", "inner": {"type": "drop"},
                   "retry": {"max_attempts": 4, "initial_delay_ms": 1, "jitter": 0.2},
                   "circuit_breaker": {"failure_threshold": 4, "reset_timeout": "50ms"},
                   "faults": [{"kind": "error", "at": 3, "times": 1}]},
        "error_output": {"type": "drop", "retry": {"max_attempts": 2, "initial_delay_ms": 1}},
    }


def _from_config(pkg) -> dict:
    cfg = pkg.config.StreamConfig.from_mapping(_chaos_cfg())
    stream = pkg.build_stream(cfg)
    parsed = {"attempts": cfg.pipeline.max_delivery_attempts,
              "retry": (cfg.output_retry.max_attempts, cfg.output_retry.jitter),
              "breaker": (cfg.output_circuit_breaker.failure_threshold,
                          cfg.output_circuit_breaker.reset_timeout_s),
              "err_retry": cfg.error_output_retry.max_attempts,
              "err_breaker": cfg.error_output_circuit_breaker,
              "reconnect": cfg.input_reconnect.max_delay_ms,
              "output_wrapped": isinstance(stream.output, pkg.wrappers.FaultInjectingOutput),
              "breaker_built": stream._out_breaker is not None}
    run(stream)
    return {**parsed, **counters(pkg, stream)}


def test_chaos_from_config_with_all_knobs():
    """Fault wrappers, output retry with jitter, the breaker,
    max_delivery_attempts, error_output retry and reconnect wire through
    from config."""
    got = both(_from_config)
    assert got["attempts"] == 2 and got["retry"] == (4, 0.2) and got["breaker"] == (4, 0.05)
    assert got["err_retry"] == 2 and got["err_breaker"] is None and got["reconnect"] == 10
    assert got["output_wrapped"] and got["breaker_built"]
    assert got["rows_out"] == 4 and got["quarantined_batches"] == 1 and got["errors"] == 2


def _refusal(pkg, family, cfg) -> str:
    with pytest.raises(pkg.ConfigError) as info:
        pkg.build_component(family, cfg, pkg.base.Resource())
    return str(info.value)


@pytest.mark.parametrize("family,cfg", [
    ("input", {"type": "fault", "inner": {"type": "memory", "messages": []},
               "faults": [{"kind": "explode", "at": 1}]}),
    ("output", {"type": "fault", "inner": {"type": "drop"}, "faults": [{"kind": "error"}]}),
    ("input", {"type": "fault"}),
    ("input", {"type": "fault", "inner": {"type": "memory", "messages": []},
               "faults": [{"kind": "error", "match": "x"}]}),
    ("output", {"type": "fault", "inner": {"type": "drop"},
                "faults": [{"kind": "ack_fail", "at": 1}]}),
    ("output", {"type": "fault", "faults": [{"kind": "error", "at": 1}]}),
    ("input", {"type": "fault", "inner": {"type": "memory", "messages": []},
               "faults": [{"kind": "burst", "every": 1, "factor": 1}]}),
])
def test_fault_config_validation(family, cfg):
    """The wrappers refuse what JAX's refuse, with JAX's messages."""
    assert _refusal(PORT, family, json.loads(json.dumps(cfg))) == \
        _refusal(JAX, family, json.loads(json.dumps(cfg)))


def _noop_source(pkg) -> dict:
    err_sink, sink = collect(pkg), collect(pkg)
    proc = pkg.wrappers.FaultInjectingProcessor(
        None, sched(pkg, [{"kind": "error", "match": "poison"}], "PROCESSOR_KINDS", "processor"))
    stream = pkg.Stream(pkg.MemoryInput([b"poison", b"fine"]), pkg.Pipeline([proc]), sink,
                        error_output=err_sink, thread_num=1, name=uname("chaos-noopack"),
                        max_delivery_attempts=5)
    run(stream)
    return {"quarantined": payloads_of(err_sink), "delivered": payloads_of(sink),
            "tags": quarantine_tags(err_sink), **counters(pkg, stream)}


def test_noop_ack_source_quarantines_immediately():
    """A source that cannot redeliver quarantines at once, below the budget."""
    got = both(_noop_source)
    assert got["quarantined"] == [b"poison"] and got["delivered"] == [b"fine"]
    assert got["tags"] == [(1, "chaos: injected error", "1")]


def test_reconnect_backoff_attempt_overflow_clamped():
    for pkg in PKGS:
        assert pkg.retry.RetryConfig(max_delay_ms=5000).delay_s(10_000) == 5.0


def test_seeded_rate_faults_are_reproducible():
    def pattern(pkg) -> list[bool]:
        s = sched(pkg, [{"kind": "error", "rate": 0.3}], "OUTPUT_KINDS", "output", seed=42)
        return [bool(s.due(i)) for i in range(1, 50)]

    a = pattern(PORT)
    assert any(a) and not all(a)
    assert a == pattern(PORT) == pattern(JAX)


# -- tests/test_runtime.py ----------------------------------------------------


def _counting_input(pkg, payloads, acked):
    class CountingAck(pkg.Ack):
        async def ack(self) -> None:
            acked.append(1)

    class AckingInput(pkg.MemoryInput):
        async def read(self):
            batch, _ = await super().read()
            return batch, CountingAck()

    return AckingInput(payloads)


def _boom(pkg) -> dict:
    acked = []

    class Boom:
        async def connect(self):
            pass

        async def process(self, batch):
            raise RuntimeError("boom")

        async def close(self):
            pass

    err_sink = collect(pkg)
    stream = pkg.Stream(_counting_input(pkg, [b"a", b"b"], acked), pkg.Pipeline([Boom()]),
                        collect(pkg), error_output=err_sink, thread_num=1,
                        name=uname("errtest"))
    run(stream)
    return {"quarantined": err_sink.dropped_batches, "acked": len(acked),
            "tags": quarantine_tags(err_sink), **counters(pkg, stream)}


def test_error_routes_to_error_output_and_acks():
    got = both(_boom)
    assert got["quarantined"] == 2 and got["acked"] == 2
    assert got["tags"] == [(1, "boom", "1")] * 2


def _flaky(pkg, monkeypatch) -> dict:
    class FlakyInput:
        def __init__(self):
            self.connects = 0
            self.reads = 0

        async def connect(self):
            self.connects += 1

        async def read(self):
            self.reads += 1
            if self.reads == 2:
                raise pkg.Disconnection("simulated drop")
            if self.reads > 4:
                raise pkg.EndOfInput()
            return pkg.batch.MessageBatch.new_binary([b"m%d" % self.reads]), pkg.NoopAck()

        async def close(self):
            pass

    inp, sink = FlakyInput(), collect(pkg)
    stream = pkg.Stream(inp, pkg.Pipeline([]), sink, thread_num=1, name=uname("flaky"))
    monkeypatch.setattr(pkg.stream_mod, "RECONNECT_DELAY_S", 0.01)
    run(stream, timeout=10)
    return {"connects": inp.connects, "delivered": payloads_of(sink)}


def test_disconnection_triggers_reconnect(monkeypatch):
    got = both(_flaky, monkeypatch)
    assert got == {"connects": 2, "delivered": [b"m1", b"m3", b"m4"]}


def _write_fail(pkg) -> dict:
    acked = []

    class FailingSink(pkg.DropOutput):
        async def write(self, batch):
            if batch.to_binary()[0] == b"poison":
                raise RuntimeError("disk full")
            await super().write(batch)

    sink = FailingSink()
    stream = pkg.Stream(_counting_input(pkg, [b"ok1", b"poison", b"ok2"], acked),
                        pkg.Pipeline([]), sink, thread_num=1, name=uname("wfail"),
                        output_retry=fast_retry(pkg))
    run(stream)
    return {"delivered": sink.dropped_batches, "acked": len(acked), **counters(pkg, stream)}


def test_write_failure_does_not_ack():
    """A write that still fails after its retries leaves the batch unacked."""
    got = both(_write_fail)
    assert got["delivered"] == 2 and got["acked"] == 2
    assert got["write_errors"] == 1 and got["output_retries"] == 2


# -- tests/test_infeed.py: coalesced delivery ---------------------------------


def _list_input(pkg, batches):
    class ListInput:
        def __init__(self):
            self._batches = list(batches)

        async def connect(self):
            return None

        async def read(self):
            if not self._batches:
                raise pkg.EndOfInput()
            return self._batches.pop(0), pkg.NoopAck()

        async def close(self):
            return None

    return ListInput()


def _coalesced(pkg, rows: list[list[bytes]], *, error_output: bool = True,
               attempts: int = 3, name: str = "coalesce-chaos") -> dict:
    inp = pkg.wrappers.FaultInjectingInput(
        _list_input(pkg, [pkg.batch.MessageBatch.new_binary(r) for r in rows]),
        sched(pkg, [], "INPUT_KINDS", "input"), redeliver_unacked=True)
    proc = pkg.wrappers.FaultInjectingProcessor(
        None, sched(pkg, [{"kind": "error", "match": "poison"}], "PROCESSOR_KINDS", "processor"))
    sink, err_sink = collect(pkg), collect(pkg)
    buffer = pkg.MemoryBuffer(capacity=64, timeout_s=0.5, coalesce_buckets=[4],
                              coalesce_deadline_s=0.05)
    stream = pkg.Stream(inp, pkg.Pipeline([proc]), sink,
                        error_output=err_sink if error_output else None, buffer=buffer,
                        thread_num=1, name=uname(name), max_delivery_attempts=attempts)
    run(stream)
    out = {"delivered": sorted(payloads_of(sink)), "quarantined": sorted(payloads_of(err_sink)),
           "tags": quarantine_tags(err_sink), "outstanding": inp._outstanding,
           **counters(pkg, stream)}
    if pkg is PORT:
        out["port_dropped"] = stream.dropped_batches
    return out


def _both_coalesced(rows, **kw) -> dict:
    jax_got, port_got = (_coalesced(pkg, rows, **kw) for pkg in PKGS)
    dropped = port_got.pop("port_dropped")
    assert port_got == jax_got
    return {**port_got, "dropped": dropped}


def test_coalesced_quarantine_after_redelivery_budget():
    """A merged emission that keeps failing is redelivered in session
    ``max_delivery_attempts`` times, then quarantined once with its tags;
    the clean emission delivers once and no delivery dangles."""
    got = _both_coalesced([[b"m0", b"poison", b"m2", b"m3"], [b"c0", b"c1", b"c2", b"c3"]])
    assert got["delivered"] == [b"c0", b"c1", b"c2", b"c3"]
    assert got["quarantined"] == [b"m0", b"m2", b"m3", b"poison"]
    assert got["quarantined_batches"] == 1 and got["errors"] == 3
    assert got["tags"] == [(4, "chaos: injected error", "3")]
    assert got["outstanding"] == 0


def test_buffered_failing_emission_is_redelivered_not_dropped():
    """Behind a memory buffer the emission's ack is redeliverable when its
    sources' are: without an error_output the failing emission is nacked
    until its last attempt, then dropped (it was dropped at its first
    failure before the composite acks carried ``redeliverable``)."""
    got = _both_coalesced([[b"m0", b"poison", b"m2", b"m3"], [b"c0", b"c1", b"c2", b"c3"]],
                          error_output=False)
    assert got["delivered"] == [b"c0", b"c1", b"c2", b"c3"] and got["quarantined"] == []
    assert got["errors"] == 3 and got["dropped"] == 1 and got["outstanding"] == 0


def test_poison_regrouping_isolated_and_quarantined():
    """A poison source whose redeliveries would regroup with fresh traffic is
    emitted alone after its first nack, so its attempts converge and it is
    quarantined; its innocent neighbours deliver on their solo retry."""
    got = _both_coalesced([[b"poison", b"p1"], [b"c0", b"c1"], [b"c2", b"c3"], [b"c4", b"c5"]])
    assert got["delivered"] == [b"c0", b"c1", b"c2", b"c3", b"c4", b"c5"]
    assert got["quarantined"] == [b"p1", b"poison"]
    assert got["quarantined_batches"] == 1 and got["outstanding"] == 0
    assert got["tags"] == [(2, "chaos: injected error", "3")]  # solo, not merged


def _ack_fail_buffered(pkg) -> dict:
    inp = pkg.wrappers.FaultInjectingInput(
        pkg.MemoryInput([b"r%d" % i for i in range(8)]),
        sched(pkg, [{"kind": "ack_fail", "at": 2}], "INPUT_KINDS", "input"),
        redeliver_unacked=True)
    sink = collect(pkg)
    buffer = pkg.MemoryBuffer(capacity=64, timeout_s=0.5, coalesce_buckets=[4],
                              coalesce_deadline_s=0.02)
    stream = pkg.Stream(inp, pkg.Pipeline([]), sink, buffer=buffer, thread_num=1,
                        name=uname("ack-fail-buffered"))
    with pytest.raises(asyncio.TimeoutError):
        asyncio.run(asyncio.wait_for(stream.run(asyncio.Event()), timeout=0.5))
    return {"outstanding": inp._outstanding, "delivered": sorted(payloads_of(sink)),
            "ack_failures": counters(pkg, stream)["ack_failures"]}


def test_ack_fail_inside_a_coalesced_emission_strands_its_later_sources():
    """The reference's composite ack stops at the first child ack that
    raises: the row whose ack failed is redelivered, the two later sources
    of its emission are never acked, and the input waits for them at EOF.
    The port reproduces it (both streams are cut by the timeout)."""
    got = both(_ack_fail_buffered)
    assert got["outstanding"] == 2 and got["ack_failures"] == 1
    assert got["delivered"] == sorted([b"r%d" % i for i in range(8)] + [b"r1"])


# -- the delivery path's own repairs ------------------------------------------


def _fanout_writes(pkg, times: int) -> dict:
    """One batch fanned out to two writes; the output fails ``times``
    writes from the second on (no retry), from a redelivering source."""

    class Twice:
        async def connect(self):
            pass

        async def process(self, batch):
            return [batch, batch]

        async def close(self):
            pass

    inp = pkg.wrappers.FaultInjectingInput(
        pkg.MemoryInput([b"x"]), sched(pkg, [], "INPUT_KINDS", "input"), redeliver_unacked=True)
    sink, err_sink = collect(pkg), collect(pkg)
    out = pkg.wrappers.FaultInjectingOutput(
        sink, sched(pkg, [{"kind": "error", "at": 2, "times": times}], "OUTPUT_KINDS", "output"))
    stream = pkg.Stream(inp, pkg.Pipeline([Twice()]), out, error_output=err_sink,
                        thread_num=1, name=uname("fanout"), max_delivery_attempts=2,
                        output_retry=retry_cfg(pkg, max_attempts=1))
    run(stream)
    return {"delivered": payloads_of(sink), "tags": quarantine_tags(err_sink),
            "tracked": len(stream._attempts), "outstanding": inp._outstanding,
            **counters(pkg, stream)}


@pytest.mark.parametrize("times", [1, 3])
def test_write_failure_counts_an_attempt_and_clears_after_every_write(times):
    """A failed write counts a delivery attempt, and a batch's attempts
    clear only once every write of it succeeded: one failure heals on
    redelivery; failures at both deliveries quarantine with attempts 2."""
    got = both(_fanout_writes, times)
    assert got["write_errors"] == min(times, 2) and got["tracked"] == 0
    assert got["outstanding"] == 0
    if times == 1:
        assert got["delivered"] == [b"x"] * 3 and got["tags"] == []
    else:
        assert got["delivered"] == [b"x"] and got["quarantined_batches"] == 1
        assert got["tags"] == [(1, "output write failed: chaos: injected error", "2")]


def test_fingerprint_ignores_ingest_time_and_ext_metadata():
    """A batch the error path tags keeps its fingerprint, so the stream's
    attempt table and the coalescer's suspect table still find it."""
    MB = PORT.batch.MessageBatch
    fp = PORT.batch.batch_fingerprint
    b = MB.new_binary([b"a", b"bb"]).with_source("memory")
    tagged = b.with_ext_metadata({"error": "boom", "delivery_attempts": "3"})
    stamped = b.with_column(PORT.batch.META_INGEST_TIME, np.array([1, 2], np.int64))
    assert fp(tagged) == fp(b) == fp(stamped)
    assert fp(b.with_ext_metadata_per_row("k", ["x", None])) == fp(b)
    assert fp(MB.new_binary([b"a", b"bc"]).with_source("memory")) != fp(b)
    assert fp(b.with_column("__meta_partition", np.array([0, 1]))) != fp(b)
    assert tagged.get_meta("__meta_ext_delivery_attempts") == "3"
    assert b.get_meta("__meta_source") == "memory" and b.get_meta("absent") is None


@pytest.mark.parametrize("flags", [(), (True,), (False,), (True, True), (True, False)])
def test_composite_acks_are_redeliverable_as_jax_s(flags):
    def flagged(pkg, flag):
        class A(pkg.NoopAck):
            redeliverable = flag
        return A()

    got = {}
    for pkg in PKGS:
        vec = pkg.base.VecAck([flagged(pkg, f) for f in flags])
        shares = pkg.base.split_ack(vec, 2) if flags else []
        pushed = pkg.base.VecAck()
        for f in flags:
            pushed.push(flagged(pkg, f))
        got[pkg.name] = (vec.redeliverable, pushed.redeliverable,
                         [getattr(s, "redeliverable", False) for s in shares],
                         pkg.base.NoopAck().redeliverable)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (bool(flags) and all(flags))


def test_fn_ack_runs_its_coroutine():
    fired = []

    async def fn():
        fired.append(1)

    asyncio.run(PORT.base.FnAck(fn).ack())
    assert fired == [1] and PORT.base.FnAck(fn).redeliverable is False


# -- the coalescer's suspects -------------------------------------------------


def _suspect_script(pkg) -> dict:
    """Emissions of a bucket-4 coalescer as sources are nacked and re-added,
    the way a redelivering input re-adds them."""
    MB = pkg.batch.MessageBatch
    c = pkg.bucketing.MicroBatchCoalescer([4])
    srcs = [MB.new_binary([b"a%d" % i, b"b%d" % i]) for i in range(4)]
    log = []

    async def go():
        for s in srcs[:2]:
            c.add(s, pkg.NoopAck())
        batch, ack = c.pop_exact()
        log.append(("merged", batch.to_binary(), ack.redeliverable))
        await ack.nack()  # both sources turn suspect
        log.append(("pending", c.pending))
        c.add(srcs[2], pkg.NoopAck())
        c.add(srcs[0], pkg.NoopAck())  # redelivered: alone, ahead of srcs[2]
        c.add(srcs[3], pkg.NoopAck())
        c.add(srcs[1], pkg.NoopAck())
        log.append(("pending", c.pending, c.rows))
        while (e := c.pop_exact()) is not None:
            log.append(("emit", e[0].to_binary()))
            await e[1].ack()
        log.append(("suspects", len(c._suspects), c.pending))

    asyncio.run(go())
    return {"log": log}


def test_suspects_emit_alone_and_first_then_clear_on_ack():
    got = both(_suspect_script)
    emits = [e[1] for e in got["log"] if e[0] == "emit"]
    assert emits[:2] == [[b"a0", b"b0"], [b"a1", b"b1"]]
    assert emits[2] == [b"a2", b"b2", b"a3", b"b3"]
    assert got["log"][-1] == ("suspects", 0, 0)


def test_healthy_adds_and_acks_never_hash(monkeypatch):
    """The row-count prefilter: with no suspect of a matching row count, an
    add or an ack computes no fingerprint."""
    calls = []
    real = PORT.bucketing.batch_fingerprint
    monkeypatch.setattr(PORT.bucketing, "batch_fingerprint",
                        lambda b: calls.append(b.num_rows) or real(b))
    c = PORT.bucketing.MicroBatchCoalescer([4])
    MB = PORT.batch.MessageBatch

    async def go():
        c.add(MB.new_binary([b"x", b"y"]), PORT.NoopAck())
        c.add(MB.new_binary([b"z", b"w"]), PORT.NoopAck())
        await c.pop_exact()[1].nack()  # marks two 2-row suspects: 2 hashes
        c.add(MB.new_binary([b"1", b"2", b"3"]), PORT.NoopAck())  # 3 rows: no hash
        await c.pop_flush()[1].ack()
        return c.suspects

    assert asyncio.run(go()) == 2
    assert calls == [2, 2]


def test_suspect_table_is_bounded(monkeypatch):
    monkeypatch.setattr(PORT.bucketing.MicroBatchCoalescer, "MAX_SUSPECTS", 3)
    c = PORT.bucketing.MicroBatchCoalescer([1])
    MB = PORT.batch.MessageBatch
    for i in range(5):
        c._mark_suspect(MB.new_binary([b"s%d" % i]))
    assert c.suspects == 3


# -- the packed BERT stream with a poison row -----------------------------------


PACKED_TEXTS = ["ok", "sensor reading looks fine", "pressure spike on line four, check valve",
                " ".join(f"token{i}" for i in range(20)), "a b c d e f g h i j k l",
                "x, y; z!"]


def _packed_poison_cfg(kind: str) -> dict:
    texts = [f"{PACKED_TEXTS[i % 6]} row{i}" for i in range(40)]
    texts[9] = "the poison row " + texts[9]
    proc = {"type": kind, "model": "bert_classifier", "model_config": TINY_BERT,
            "max_seq": 32, "batch_buckets": [2, 4, 8], "seq_buckets": [16, 32],
            "packing": True, "outputs": ["label", "score", "logits"]}
    if kind == "gpu_inference":
        proc["device"] = "cpu"
    return {"name": uname("packed-poison"),
            "input": {"type": "fault", "redeliver_unacked": True,
                      "inner": {"type": "memory", "messages": texts}},
            "buffer": {"type": "memory", "capacity": 8, "timeout": "5ms",
                       "coalesce": {"batch_buckets": [8], "deadline": "50ms",
                                    "token_budget": 8 * 32 - 2 * 32, "max_row_tokens": 32}},
            "pipeline": {"thread_num": 1, "max_delivery_attempts": 3, "processors": [
                {"type": "fault", "faults": [{"kind": "error", "match": "poison"}],
                 "inner": proc}]},
            "output": {"type": "drop"}, "error_output": {"type": "drop"}}


def _rows_by_payload(sink) -> dict:
    out = {}
    for b in sink.batches:
        col = b.column("logits")
        logits = (np.asarray(col, np.float32) if isinstance(col, np.ndarray)
                  else np.asarray(col.flatten(), np.float32).reshape(b.num_rows, -1))
        for p, label, row in zip(b.to_binary(), np.asarray(b.column("label")), logits):
            out[p] = (int(label), np.asarray(row, np.float32))
    return out


def test_packed_poison_row_is_quarantined_alone_and_labels_match_jax():
    """A TINY_BERT packed stream through the token-budget memory buffer, one
    poison text among 40: it is quarantined alone after 3 attempts, every
    other row is delivered once, with labels equal to the JAX stream's on
    tie-free rows and logits within 1/64."""
    from arkflow_tpu_torch.convert import params_from_jax
    from arkflow_tpu_torch.tpu.runner import ModelRunner

    jax_cfg = _packed_poison_cfg("tpu_inference")
    poison = [t.encode() for t in jax_cfg["input"]["inner"]["messages"] if "poison" in t]
    jstream = JAX.build_stream(JAX.config.StreamConfig.from_mapping(jax_cfg))
    jsink = jstream.output = collect(JAX)
    jerr = jstream.error_output = collect(JAX)
    run(jstream, timeout=60)
    host = jax.device_get(jstream.pipeline.processors[0]._inner.runner.host_params)

    stream = PORT.build_stream(PORT.config.StreamConfig.from_mapping(
        _packed_poison_cfg("gpu_inference")))
    proc = stream.pipeline.processors[0]._inner
    proc.runner = ModelRunner("bert_classifier", TINY_BERT, buckets=proc.runner.buckets,
                              device="cpu", host_params=params_from_jax(host), packed=True)
    sink = stream.output = collect(PORT)
    err = stream.error_output = collect(PORT)
    run(stream, timeout=60)

    for e in (err, jerr):
        assert [b.num_rows for b in e.batches] == [1]
        assert e.batches[0].get_meta("__meta_ext_delivery_attempts") == "3"
    assert payloads_of(err) == payloads_of(jerr) == poison
    assert stream.quarantined_batches == 1 and int(jstream.m_quarantined.value) == 1
    assert stream.errors == int(jstream.m_errors.value) and stream.input._outstanding == 0
    got, want = _rows_by_payload(sink), _rows_by_payload(jsink)
    assert sorted(got) == sorted(want) and len(got) == 39
    assert sorted(payloads_of(sink)) == sorted(got)  # each once
    tie_free = 0
    for p, (label, logits) in want.items():
        np.testing.assert_allclose(got[p][1], logits, atol=LOGIT_ATOL, rtol=0)
        top2 = np.sort(logits)
        if top2[-1] - top2[-2] > TIE_MARGIN:
            tie_free += 1
            assert got[p][0] == label, p
    assert tie_free >= 10
    assert proc.runner.packed_steps == proc.runner.device_steps


# -- the examples -------------------------------------------------------------


def _chaos_example(pkg, raw: dict) -> dict:
    cfg = pkg.config.StreamConfig.from_mapping(raw)
    stream = pkg.build_stream(cfg)
    sink, err = collect(pkg), collect(pkg)
    stream.output._inner, stream.error_output = sink, err
    run(stream)
    br = stream._out_breaker
    return {"delivered": sorted(payloads_of(sink)), "quarantined": payloads_of(err),
            "tags": quarantine_tags(err), "history": br.history,
            "probes": stream.input._reconnects, **counters(pkg, stream)}


def test_chaos_example_matches_the_jax_example():
    """``chaos_stream.json`` is ``examples/chaos_example.yaml`` in JSON, keys
    unchanged: each healthy row once, the poison row quarantined after 3
    attempts, three write retries and one trip of the breaker, in both."""
    import yaml

    jax_raw = yaml.safe_load((ROOT / "examples/chaos_example.yaml").read_text())
    port_raw = json.loads((ROOT / "arkflow_tpu_torch/examples/chaos_stream.json").read_text())
    assert port_raw["streams"][0] == jax_raw["streams"][0]
    assert port_raw["health_check"]["port"] == 0
    got = {}
    for pkg, raw in ((JAX, jax_raw), (PORT, port_raw)):
        s = json.loads(json.dumps(raw["streams"][0]))
        s["name"] = uname(s["name"])
        got[pkg.name] = _chaos_example(pkg, s)
    assert got["port"] == got["jax"]
    assert len(got["port"]["delivered"]) == 5 and got["port"]["quarantined_batches"] == 1
    assert got["port"]["tags"] == [(1, "chaos: injected error", "3")]
    assert got["port"]["output_retries"] == 3 and got["port"]["probes"] == 1
    assert got["port"]["history"] == ["closed", "open", "half_open", "closed"]


def test_chaos_example_runs_through_the_cli(capfd):
    from arkflow_tpu_torch.runtime import cli

    path = str(ROOT / "arkflow_tpu_torch/examples/chaos_stream.json")
    assert cli.main(["--config", path, "--validate"]) == 0
    assert cli.main(["--config", path]) == 0
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("{")]
    assert sorted(lines) == sorted(f'{{"id": {i}, "kind": "{k}"}}' for i, k in
                                   ((1, "ok"), (2, "ok"), (3, "poison"), (4, "ok"),
                                    (5, "ok"), (6, "ok")))


def test_bert_delivery_example_runs_on_the_cpu():
    """The delivery example at a tiny width: its poison text quarantined
    alone after 3 attempts, every other text delivered once, the disconnect
    healed after one failed probe."""
    raw = json.loads((ROOT / "arkflow_tpu_torch/examples/bert_delivery_stream.json").read_text())
    s = raw["streams"][0]
    inner = s["pipeline"]["processors"][0]["inner"]
    inner.update(model_config={**TINY_BERT, "max_positions": 256}, device="cpu", warmup=False)
    texts = s["input"]["inner"]["messages"]
    stream = PORT.build_stream(PORT.config.StreamConfig.from_mapping(s))
    sink, err = collect(PORT), collect(PORT)
    stream.output._inner, stream.error_output = sink, err
    run(stream, timeout=60)
    poison = [t.encode() for t in texts if "poison" in t]
    assert len(poison) == 1 and payloads_of(err) == poison
    assert quarantine_tags(err) == [(1, "chaos: injected error", "3")]
    assert sorted(payloads_of(sink)) == sorted(t.encode() for t in texts if "poison" not in t)
    assert stream.reconnects == 1 and stream.reconnect_failures == 1
    assert stream.input._outstanding == 0 and stream.quarantine_drops == 0
