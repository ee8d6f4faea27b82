"""The port's shape tuner (``tpu/tuner.py``) against the JAX package's: the
``tuner`` block's parse and its refusals (through fault wrappers too), the
planner (``plan_shapes``, ``quantile_aligned_edges``, ``predict_waste``)
on seeded sketches, the sketch under an injected clock, the cap bus's and
the memory buffer's retarget, the runner's padding counters, and a forced
cycle on a port runner beside the JAX runner on the same weights and the
same lengths: the same committed grid, nothing captured on the path after
the warm, outputs within the bf16 floor. Then hysteresis, a probe failure's
rollback, a warm abandoned at its deadline or out of memory, a bound
listener, ``POST /admin/tune`` and ``/health`` on the engine, and a short
shifting-length stream that commits once and loses no row."""

import asyncio
import dataclasses
import json
import time

import jax
import numpy as np
import pytest

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.config import StreamConfig as JaxStreamConfig
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.plugins.buffer.memory import MemoryBuffer as JaxMemoryBuffer
from arkflow_tpu.tpu import tuner as jt
from arkflow_tpu.tpu.bucketing import BucketCapBus as JaxBucketCapBus
from arkflow_tpu.tpu.bucketing import BucketPolicy as JaxBucketPolicy
from arkflow_tpu.tpu.bucketing import MicroBatchCoalescer as JaxCoalescer
from arkflow_tpu.tpu.bucketing import bucket_cap_bus as jax_bucket_cap_bus
from arkflow_tpu.tpu.runner import ModelRunner as JaxModelRunner
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import (Input, NoopAck, Output, Resource, build_component,
                                          ensure_plugins_loaded)
from arkflow_tpu_torch.config import EngineConfig, StreamConfig
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError, EndOfInput, TunerError
from arkflow_tpu_torch.plugins.buffer.memory import MemoryBuffer
from arkflow_tpu_torch.runtime import cli
from arkflow_tpu_torch.runtime.engine import Engine
from arkflow_tpu_torch.tpu import tuner as pt
from arkflow_tpu_torch.tpu.bucketing import (BucketCapBus, BucketPolicy, MicroBatchCoalescer,
                                             bucket_cap_bus)
from arkflow_tpu_torch.tpu.packing import pack_tokens
from arkflow_tpu_torch.tpu.runner import ModelRunner, shape_key
from arkflow_tpu_torch.tpu.serving_core import InjectedOom
from tests.test_torch_coalesce import JaxRecAck, RecAck, _buffer_emissions, _writes
from tests.test_torch_lifecycle_stream import _http
from tests.test_tpu_layer import TINY_BERT

ensure_plugins_loaded()

LOGIT_ATOL = 1.0 / 64
TIE_MARGIN = 0.05
BATCH, SEQ = (4, 8), (32, 64)


@pytest.fixture(autouse=True)
def _reset_buses():
    yield
    bucket_cap_bus().reset()
    jax_bucket_cap_bus().reset()


# -- config ---------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    None, False, True, {}, {"enabled": False}, {"interval": 0},
    {"interval": "5s", "min_improvement": 0.05, "target_fill": 0.9, "align": 16,
     "max_compiles": 8, "min_samples": 32, "window": 512, "deadline_min": "20ms",
     "deadline_max": "2s", "deadline_slack": 2.0, "max_seq_buckets": 3},
    "nope", [1], {"bogus": 1}, {"min_improvement": 2.0}, {"align": 0}, {"enabled": "yes"},
    {"window": 4}, {"deadline_slack": 0.5}, {"target_fill": 0.0}, {"max_compiles": True},
    {"deadline_min": "2s", "deadline_max": "1s"}, {"interval": "-1s"},
    {"deadline_min": "0s"}, {"min_improvement": -1}, {"deadline_slack": True},
])
def test_parse_tuner_config_matches_jax(cfg):
    try:
        want = jt.parse_tuner_config(cfg, who="gpu_inference")
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            pt.parse_tuner_config(cfg, who="gpu_inference")
        assert str(got.value) == str(e)
        return
    got = pt.parse_tuner_config(cfg, who="gpu_inference")
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _stream_cfg(kind: str, tuner, wrapped: bool) -> dict:
    proc = {"type": kind, "model": "bert_classifier", "tuner": tuner}
    if wrapped:
        proc = {"type": "fault", "faults": [], "inner": proc}
    return {"input": {"type": "generate", "payload": "x", "count": 1},
            "pipeline": {"processors": [proc]}, "output": {"type": "drop"}}


@pytest.mark.parametrize("tuner,ok", [
    ({"interval": "10s"}, True), ({"interval": "10s", "nope": 1}, False),
    ({"min_improvement": -1}, False), ({"window": 4}, False),
])
@pytest.mark.parametrize("wrapped", [False, True])
def test_validation_through_fault_wrappers_matches_jax(tmp_path, tuner, ok, wrapped):
    """``StreamConfig`` refuses a bad block at parse time where the JAX
    package's does, with JAX's message, and ``--validate`` exits 2."""
    if ok:
        StreamConfig.from_mapping(_stream_cfg("gpu_inference", tuner, wrapped))
        JaxStreamConfig.from_mapping(_stream_cfg("tpu_inference", tuner, wrapped))
    else:
        with pytest.raises(JaxConfigError) as want:
            JaxStreamConfig.from_mapping(_stream_cfg("tpu_inference", tuner, wrapped))
        with pytest.raises(ConfigError) as got:
            StreamConfig.from_mapping(_stream_cfg("gpu_inference", tuner, wrapped))
        assert str(got.value) == str(want.value).replace("tpu_inference", "gpu_inference")
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"streams": [_stream_cfg("gpu_inference", tuner, wrapped)]}))
    assert cli.main(["--config", str(path), "--validate"]) == (0 if ok else 2)


def test_adaptive_example_validates_and_builds():
    with open("arkflow_tpu_torch/examples/bert_adaptive_stream.json") as f:
        raw = json.load(f)
    proc = raw["streams"][0]["pipeline"]["processors"][0]
    proc.update(device="cpu", model_config={**TINY_BERT, "max_positions": 128}, warmup=False)
    engine = Engine(EngineConfig.from_mapping(raw))
    assert engine.config.validate_components() == []
    stream = engine.build()[0]
    tuner = stream.pipeline.processors[0].tuner
    assert tuner.cfg == pt.parse_tuner_config(proc["tuner"])
    assert tuner.packed and tuner.report()["incumbent"]["seq_buckets"] == [32, 64, 128]


# -- the planner ------------------------------------------------------------------


def _lengths(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "skewed short":
        return rng.integers(8, 20, size=2048)
    if kind == "bimodal":
        return np.concatenate([rng.integers(8, 16, size=128) if i % 2 == 0
                               else rng.integers(90, 118, size=128) for i in range(16)])
    if kind == "shifting":
        return np.concatenate([rng.integers(6, 25, size=1024), rng.integers(60, 121, size=1024)])
    return rng.integers(1, 200, size=777)  # wide, over the top bucket


INCUMBENTS = {
    "padded": dict(batch_buckets=(8, 16, 32), seq_buckets=(32, 64, 128)),
    "packed": dict(batch_buckets=(8, 16, 32, 64), seq_buckets=(32, 64, 128), packed=True,
                   example_scale=4, token_budget=64 * 128),
    "packed, no budget": dict(batch_buckets=(8,), seq_buckets=(32, 64), packed=True),
}
#: (knobs, observed arrival rate): JAX's defaults with a rate (the deadline
#: is derived), and other knobs without one (the deadline is left)
CONFIGS = [({}, 500.0), ({"align": 16, "max_seq_buckets": 2, "target_fill": 0.9}, 0.0)]


@pytest.mark.parametrize("kind", ["skewed short", "bimodal", "shifting", "wide"])
@pytest.mark.parametrize("incumbent", list(INCUMBENTS))
@pytest.mark.parametrize("knobs", range(len(CONFIGS)))
def test_planner_matches_jax_exactly(kind, incumbent, knobs):
    lengths = _lengths(kind, seed=len(kind) + knobs)
    knobs, rate = CONFIGS[knobs]
    got = pt.plan_shapes(pt.SketchView(lengths, rate, lengths.size),
                         pt.ShapeConfig(**INCUMBENTS[incumbent]), pt.TunerConfig(**knobs))
    want = jt.plan_shapes(jt.SketchView(lengths, rate, lengths.size),
                          jt.ShapeConfig(**INCUMBENTS[incumbent]), jt.TunerConfig(**knobs))
    assert dataclasses.asdict(got.shape) == dataclasses.asdict(want.shape)
    for field in ("predicted_waste", "predicted_fill", "incumbent_waste", "improvement", "notes"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.report() == want.report()


@pytest.mark.parametrize("kind", ["skewed short", "bimodal", "shifting", "wide"])
def test_edges_and_waste_match_jax_exactly(kind):
    lengths = _lengths(kind, seed=3)
    for top, align, qs in ((128, 8, (0.25, 0.9)), (64, 16, (0.5,)), (512, 8, (0.1, 0.5, 0.99))):
        assert pt.quantile_aligned_edges(lengths, top, align=align, qs=qs) == \
            jt.quantile_aligned_edges(lengths, top, align=align, qs=qs)
    for shape in (*INCUMBENTS.values(), dict(batch_buckets=(4, 64), seq_buckets=(24, 40, 88, 128),
                                             packed=True, token_budget=2000)):
        assert pt.predict_waste(pt.SketchView(lengths, 0.0, lengths.size), pt.ShapeConfig(**shape)) \
            == jt.predict_waste(jt.SketchView(lengths, 0.0, lengths.size), jt.ShapeConfig(**shape))


def test_sketch_window_rate_and_wraparound_match_jax():
    sketches = []
    for mod in (pt, jt):
        t = [0.0]
        sk = mod.WorkloadSketch(window=16, clock=lambda t=t: t[0])
        for i in range(10):
            sk.observe(np.full(8 if i % 3 else 5, 10 + i))
            t[0] += 0.1 + 0.01 * i
        sk.observe(np.arange(40))  # more than the window at once
        sketches.append(sk.snapshot())
    got, want = sketches
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert (got.arrival_rows_per_sec, got.rows_seen) == (want.arrival_rows_per_sec,
                                                         want.rows_seen)
    assert got.n == 16 and list(got.lengths) == list(range(24, 40))


# -- the bus and the memory buffer ------------------------------------------------


def _bus_state(coalescers):
    return [(c.buckets, c.token_budget) for c in coalescers]


def test_bus_retarget_scoping_and_cap_match_jax():
    states = []
    for bus_cls, coal_cls in ((BucketCapBus, MicroBatchCoalescer),
                              (JaxBucketCapBus, JaxCoalescer)):
        bus = bus_cls()
        mine = coal_cls([4, 8], token_budget=256)
        other = coal_cls([16, 64])
        rows = coal_cls([4, 8])
        for c in (mine, other, rows):
            bus.register(c)
        log = []
        bus.retarget((4, 8, 16), token_budget=512, expect=(4, 8))
        log.append(_bus_state((mine, other, rows)))
        bus.announce(8)  # an OOM cap always wins over a retarget
        log.append(_bus_state((mine, other, rows)))
        bus.retarget((4, 8, 16), token_budget=900, expect=(4, 8))
        log.append(_bus_state((mine, other, rows)))
        bus.retarget((32,), token_budget=64, expect=None)
        log.append(_bus_state((mine, other, rows)))
        log.append(bus.clamp((2, 4, 8, 16), 1600))
        states.append(log)
    assert states[0] == states[1]
    assert states[0][0][0] == ((4, 8, 16), 512) and states[0][0][1] == ((16, 64), None)
    assert states[0][2][0] == ((4, 8), 450) and states[0][4] == ((2, 4, 8), 800)


def test_broadcast_retargets_a_listeners_coalescer_once(monkeypatch):
    """A buffer's coalescer follows a broadcast through its buffer alone,
    under the buffer's backpressure bound; a bare coalescer follows the
    bus."""
    buf = build_component("buffer", {"type": "memory", "capacity": 4, "timeout": "50ms",
                                     "coalesce": {"batch_buckets": [4, 8], "deadline": "20ms"}},
                          Resource())
    bare = MicroBatchCoalescer([4, 8])
    bucket_cap_bus().register(bare)
    calls = []
    real = MicroBatchCoalescer.retarget

    def counted(self, buckets, token_budget=None):
        calls.append((self is buf.coalescer, tuple(buckets)))
        return real(self, buckets, token_budget)

    monkeypatch.setattr(MicroBatchCoalescer, "retarget", counted)
    bucket_cap_bus().retarget((4, 8, 32), deadline_s=0.01, expect=(4, 8))
    assert sorted(calls) == [(False, (4, 8, 32)), (True, (4, 8))]
    assert buf.coalescer.buckets == (4, 8) and bare.buckets == (4, 8, 32)
    assert buf._deadline_s == 0.01


@pytest.mark.parametrize("retarget", [
    ((4, 8, 16), 150, 0.005, (99,)),        # another stream's grid: nothing moves
    ((4, 16), 150, 0.003, (8, 32)),
    ((4, 16), None, None, (8, 32)),         # the budget and deadline left as they are
    ((8, 100000), 97, None, None),          # above the backpressure bound: dropped
])
@pytest.mark.parametrize("token_mode", [False, True])
def test_memory_buffer_follows_a_retarget_like_jax(retarget, token_mode):
    """The same writes into both buffers, a bus retarget after half of
    them, then the rest: the same emissions, acks, adopted grid, budget and
    deadline."""
    buckets, budget, deadline, expect = retarget
    writes = [w for w in _writes(11, 16) if w]
    kwargs = {"capacity": 128, "timeout_s": 5.0, "coalesce_buckets": [8, 32],
              "coalesce_deadline_s": 5.0,
              **({"token_budget": 300, "max_row_tokens": 16} if token_mode else {})}

    async def drive(buf, batch_cls, ack_cls, bus):
        log, out = [], []
        for i, texts in enumerate(writes):
            if i == len(writes) // 2:
                bus.retarget(buckets, token_budget=budget, deadline_s=deadline, expect=expect)
            await buf.write(batch_cls.new_binary(texts), ack_cls(log, i))
        await buf.close()
        while (item := await buf.read()) is not None:
            out.append(item[0].num_rows)
            await item[1].ack()
        c = buf._coalescer
        return out, sorted(log), buf._deadline_s, tuple(c.buckets), c.token_budget

    got = asyncio.run(drive(MemoryBuffer(**kwargs), MessageBatch, RecAck, bucket_cap_bus()))
    want = asyncio.run(drive(JaxMemoryBuffer(**kwargs), JaxBatch, JaxRecAck,
                             jax_bucket_cap_bus()))
    assert got == want and sum(got[0]) == sum(len(w) for w in writes)


def test_memory_buffer_emissions_after_a_retarget_equal_jax():
    writes = [w for w in _writes(5, 14) if w]
    got_log, want_log = [], []
    results = []
    for buf_cls, batch_cls, ack_cls, bus, log in (
            (MemoryBuffer, MessageBatch, RecAck, bucket_cap_bus(), got_log),
            (JaxMemoryBuffer, JaxBatch, JaxRecAck, jax_bucket_cap_bus(), want_log)):
        buf = buf_cls(capacity=64, timeout_s=5.0, coalesce_buckets=[64],
                      coalesce_deadline_s=5.0, token_budget=400, max_row_tokens=16)
        assert buf.retarget_shapes((16, 64), 120, 0.01, expect=(64,)) is True
        assert buf.retarget_shapes((16,), 50, 0.02, expect=(64,)) is False
        results.append(asyncio.run(_buffer_emissions(buf, batch_cls, ack_cls, writes, log)))
    assert results[0] == results[1] and sum(results[0]) == sum(len(w) for w in writes)
    assert sorted(got_log) == sorted(want_log)


# -- runners ------------------------------------------------------------------------


def _host_params(seed: int = 0):
    fam = jax_get_model("bert_classifier")
    return jax.device_get(fam.init(jax.random.PRNGKey(seed), fam.make_config(**TINY_BERT)))


def _runners(packed: bool, host, batch=BATCH, seq=SEQ):
    es = {"example_scale": 4} if packed else {}
    port = ModelRunner("bert_classifier", TINY_BERT, buckets=BucketPolicy(batch, seq, **es),
                       device="cpu", host_params=params_from_jax(host), packed=packed)
    jaxr = JaxModelRunner("bert_classifier", TINY_BERT,
                          buckets=JaxBucketPolicy(batch, seq, **es), host_params=host,
                          packed=packed)
    return port, jaxr


def _clocked(mod, runner, packed: bool, **over):
    cfg = mod.TunerConfig(**{"min_samples": 64, "min_improvement": 0.01, **over})
    tuner = mod.ShapeTuner(runner, model="bert_classifier", cfg=cfg, packed=packed)
    t = [0.0]

    def clock():
        t[0] += 0.01
        return t[0]

    tuner.sketch = mod.WorkloadSketch(cfg.window, clock=clock)
    return tuner


def _batch_inputs(rng, lengths: np.ndarray, packed: bool, buckets) -> dict:
    width = int(lengths.max())
    ids = rng.integers(4, TINY_BERT["vocab_size"], (len(lengths), width)).astype(np.int32)
    mask = (np.arange(width)[None, :] < lengths[:, None]).astype(np.int32)
    sb = buckets.seq_bucket(width)
    if not packed:
        return {"input_ids": (ids * mask)[:, :sb], "attention_mask": mask[:, :sb]}
    pk = pack_tokens(ids * mask, lengths, sb)
    return {"input_ids": pk.input_ids, "segment_ids": pk.segment_ids,
            "position_ids": pk.position_ids, "example_row": pk.example_row,
            "example_pos": pk.example_pos}


def _serve(runner, tuner, lengths: list[np.ndarray], packed: bool, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)

    async def go():
        outs = []
        for ls in lengths:
            tuner.observe(ls)
            outs.append(await runner.infer(_batch_inputs(rng, ls, packed, runner.buckets)))
        return outs

    return asyncio.run(go())


def _traffic_counts(r: ModelRunner) -> tuple:
    return (r.rows, r.padded_rows, r.executed_rows, r.true_tokens, r.token_capacity,
            r.dispatch_counts(), r._duty.busy_s + r._duty.stall_s)


def _assert_close(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["logits"], want["logits"], atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want["logits"], axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > TIE_MARGIN
    np.testing.assert_array_equal(got["label"][tie_free], want["label"][tie_free])


@pytest.mark.parametrize("packed", [False, True])
def test_padding_counters_match_jax(packed):
    port, jaxr = _runners(packed, _host_params())
    rng = np.random.default_rng(5)
    for n in (3, 8, 5):
        ls = rng.integers(1, 50, n)
        inputs = _batch_inputs(rng, ls, packed, port.buckets)
        port.infer_sync(inputs)
        jaxr.infer_sync(inputs)
    assert (port.padded_rows, port.executed_rows, port.true_tokens, port.token_capacity) == (
        jaxr.m_pad.value, jaxr.m_exec_rows.value, jaxr.m_tokens.value,
        jaxr.m_token_capacity.value)
    padding = port.health_report()["padding"]
    assert padding["true_tokens"] == port.true_tokens > 0


@pytest.mark.parametrize("packed", [False, True])
def test_forced_cycle_commits_the_jax_grid_and_captures_nothing_on_path(packed):
    host = _host_params()
    port, jaxr = _runners(packed, host)
    tuners = [_clocked(pt, port, packed), _clocked(jt, jaxr, packed)]
    lengths = [np.full(8 if not packed else 12, 12)] * 10
    for runner, tuner in zip((port, jaxr), tuners):
        _serve(runner, tuner, lengths, packed)
    captures, counts = port.captures, _traffic_counts(port)

    async def cycle(tuner):
        return await tuner.run_cycle(force=True)

    got, want = (asyncio.run(cycle(t)) for t in tuners)
    assert got["action"] == want["action"] == "committed"
    assert got["proposal"] == want["proposal"]
    assert dataclasses.asdict(tuners[0]._incumbent) == dataclasses.asdict(tuners[1]._incumbent)
    assert port.buckets == tuners[0]._incumbent.to_policy()
    assert port.count_new_shapes(port.buckets) == 0
    assert got["warmed_shapes"] == got["new_shapes"] == port.warm_captures > 0
    # neither the warm nor the probe was traffic, and the path captured nothing
    assert port.captures == captures and _traffic_counts(port) == counts
    rng = np.random.default_rng(9)
    for ls in (np.full(8, 12), np.array([3, 12, 7, 1]), np.full(6, 40)):
        inputs = _batch_inputs(rng, ls, packed, port.buckets)
        _assert_close(port.infer_sync(inputs), jaxr.infer_sync(inputs))
    assert port.captures == captures
    assert tuners[0].report()["graphs"] == {"keys": len(port._compiled), "captures": captures,
                                            "warm_captures": port.warm_captures,
                                            "released": 0}


def test_warm_shapes_captures_a_grid_apart_from_the_path():
    port, _ = _runners(False, _host_params())
    assert port.warmup() == len(BATCH) * len(SEQ)
    captures = port.captures
    policy = BucketPolicy(BATCH, (16, 24, 64))
    assert port.count_new_shapes(policy) == 4
    assert port.warm_shapes(policy) == 4 and port.warm_shapes(policy) == 0
    assert port.count_new_shapes(policy) == 0
    assert port.captures == captures and port.warm_captures == 4
    assert port.retarget_buckets(policy).seq_buckets == SEQ
    rng = np.random.default_rng(2)
    for ls in (np.full(3, 20), np.full(8, 11), np.full(5, 50)):
        port.infer_sync(_batch_inputs(rng, ls, False, policy))
    assert port.captures == captures and len(port.dispatch_counts()) == 3
    assert port.health_report()["warm_captures"] == 4 and port.rows == 16


def test_stable_workload_rejects_every_later_cycle():
    port, _ = _runners(False, _host_params())
    tuner = _clocked(pt, port, False)
    _serve(port, tuner, [np.full(8, 12)] * 12, False)

    async def go():
        assert (await tuner.run_cycle(force=True))["action"] == "committed"
        for _ in range(3):
            assert (await tuner.run_cycle(force=True))["action"] == "rejected"

    asyncio.run(go())
    assert tuner.epoch == 1 and tuner.rejected == 3 and tuner.proposals == 4


def test_probe_failure_rolls_back_and_touches_nothing():
    port, _ = _runners(False, _host_params())
    tuner = _clocked(pt, port, False)
    flushed = []
    tuner.add_commit_hook(lambda: flushed.append(1))
    coal = MicroBatchCoalescer([4, 8])
    bucket_cap_bus().register(coal)
    _serve(port, tuner, [np.full(8, 12)] * 12, False)
    grid = port.buckets
    tuner.inject_fault("probe_fail")
    with pytest.raises(ConfigError, match="unknown tuner fault"):
        tuner.inject_fault("bitflip")

    async def go():
        with pytest.raises(TunerError, match="rolled back"):
            await tuner.run_cycle(force=True)

    asyncio.run(go())
    assert port.buckets == grid and tuner.epoch == 0 and tuner.rollbacks == 1
    assert coal.buckets == (4, 8) and flushed == []
    assert tuner.report()["last_decision"]["action"] == "rolled_back"
    assert port.health_report()["state"] == "unhealthy"  # marked as a dispatcher marks it


def test_warm_abandoned_at_its_deadline_fails_before_any_flip(monkeypatch):
    port, _ = _runners(False, _host_params())
    tuner = _clocked(pt, port, False)
    _serve(port, tuner, [np.full(8, 12)] * 12, False)
    grid = port.buckets
    port.core.step_deadline_s, port.core.step_deadline_first_s = 5.0, 0.3
    real = port._capture_keys

    def wedged(compiled, keys, warm=False):
        time.sleep(0.8)
        real(compiled, keys, warm)

    monkeypatch.setattr(port, "_capture_keys", wedged)

    async def go():
        with pytest.raises(TunerError, match="warm failed"):
            await tuner.run_cycle(force=True)

    asyncio.run(go())
    assert port.buckets == grid and tuner.epoch == 0
    assert tuner.report()["last_decision"]["action"] == "warm_failed"
    assert port.deadline_misses == 1
    port.core.step_deadline_first_s = 30.0
    port.infer_sync(_batch_inputs(np.random.default_rng(0), np.full(4, 9), False, grid))
    assert port.rebuilds == 1 and port.buckets == grid
    # the rebuild captured the incumbent grid's keys again, none of the proposal's
    assert set(port._compiled.keys()) <= {shape_key(s) for s in port.grid_shapes(grid)}


def test_oom_in_a_warm_caps_the_grid_and_the_next_cycle_adopts_it(monkeypatch):
    port, _ = _runners(False, _host_params())
    tuner = _clocked(pt, port, False)
    coal = MicroBatchCoalescer([4, 8])
    bucket_cap_bus().register(coal)
    _serve(port, tuner, [np.full(8, 12)] * 12, False)

    real = port._capture_keys

    def oom_at_8_rows(compiled, keys, warm=False):
        if dict(keys[0])["input_ids"][0] == 8:
            raise InjectedOom()
        real(compiled, keys, warm)

    monkeypatch.setattr(port, "_capture_keys", oom_at_8_rows)

    async def go():
        with pytest.raises(TunerError, match="warm failed"):
            await tuner.run_cycle(force=True)
        monkeypatch.undo()
        return await tuner.run_cycle(force=True)

    rep = asyncio.run(go())
    assert port.ooms == 1 and port.buckets.batch_buckets == (4,) and coal.buckets == (4,)
    assert rep["action"] == "committed" and rep["proposal"]["shape"]["batch_buckets"] == [4]


def _grid_keys(runner, *policies) -> set:
    return {shape_key(s) for p in policies for s in runner.grid_shapes(p)}


def test_release_keeps_the_live_kept_and_held_grids():
    """A release drops the graphs of keys in no grid that may still serve:
    the live one, the kept rollback grid and the grids steps in flight
    hold, whose keys go when their last holder lets go."""
    port, _ = _runners(False, _host_params())
    port.warmup()
    a, b, c = port.buckets, BucketPolicy(BATCH, (16, 64)), BucketPolicy(BATCH, (24, 64))
    port.warm_shapes(b)
    port.retarget_buckets(b)
    assert port.release_graphs(keep=(a,)) == 0  # a commit keeps its rollback grid
    held = port.hold_grid(a)  # a window carved on A, not yet padded
    port.warm_shapes(c)
    port.retarget_buckets(c)
    assert port.release_graphs(keep=(b,)) == 0  # A-only keys wait for the holder
    assert set(port._compiled.keys()) == _grid_keys(port, a, b, c)
    assert port.let_go(held) and port.sweep() == 2
    assert set(port._compiled.keys()) == _grid_keys(port, b, c)
    assert port.graph_counts()["released"] == port.released_graphs == 2
    # a rollback (no new keep) drops the candidate's warm captures
    d = BucketPolicy(BATCH, (40, 64))
    port.warm_shapes(d)
    assert port.retarget_buckets(d) == c
    port.retarget_buckets(c)
    assert port.release_graphs() == 2 and set(port._compiled.keys()) == _grid_keys(port, b, c)
    # a step on a released key captures it again on the path
    captures = port.captures
    port.infer_sync(_batch_inputs(np.random.default_rng(1), np.full(4, 20), False, a),
                    policy=a)
    assert port.captures == captures + 1 and port.buckets == c and not port._held


def test_commit_and_rollback_release_what_no_grid_serves():
    """The tuner's cycle releases after each outcome: a commit keeps its
    rollback grid, a rolled-back candidate's warm captures go."""
    port, _ = _runners(False, _host_params())
    port.warmup()
    static = port.buckets
    tuner = _clocked(pt, port, False, window=64)
    _serve(port, tuner, [np.full(8, 12)] * 12, False)

    async def go():
        first = await tuner.run_cycle(force=True)
        for ls in [np.full(8, 44)] * 12:
            tuner.observe(ls)
        tuner.inject_fault("probe_fail")
        with pytest.raises(TunerError, match="rolled back"):
            await tuner.run_cycle(force=True)
        return first

    first = asyncio.run(go())
    assert first["action"] == "committed" and tuner.rollbacks == 1
    committed = port.buckets
    assert set(port._compiled.keys()) == _grid_keys(port, static, committed)
    warmed_in_rollback = port.warm_captures - first["warmed_shapes"]
    assert warmed_in_rollback > 0 and port.released_graphs == warmed_in_rollback
    assert tuner.report()["graphs"]["released"] == warmed_in_rollback


def test_packed_windows_keep_the_grid_they_were_carved_for(monkeypatch):
    """A flip that lowers ``example_scale`` (8 -> 2) between a batch's
    carve and its windows' padding: the windows are padded on the grid they
    were carved for (the flipped grid cannot hold them), and every row comes
    back equal to the run without the flip."""
    proc = build_component("processor", {
        "type": "gpu_inference", "model": "bert_classifier",
        "model_config": TINY_BERT, "max_seq": 32, "batch_buckets": [4, 8],
        "seq_buckets": [16, 32], "example_scale": 8, "device": "cpu", "packing": True,
        "outputs": ["label", "logits"]}, Resource())
    runner = proc.runner
    carved_on = runner.buckets
    flipped = dataclasses.replace(carved_on, example_scale=2)
    assert flipped.max_examples() < carved_on.max_examples()
    batch = MessageBatch.new_binary([b"w%d" % i for i in range(160)])
    want = asyncio.run(proc.process(batch))[0]
    windows = proc._pack(batch, carved_on)
    fat = max(windows, key=lambda w: w[0]["example_row"].shape[0])[0]
    assert fat["example_row"].shape[0] > flipped.max_examples()
    real = proc._pack

    def pack_then_flip(b, policy):
        out = real(b, policy)
        runner.retarget_buckets(flipped)
        return out

    monkeypatch.setattr(proc, "_pack", pack_then_flip)
    got = asyncio.run(proc.process(batch))[0]
    assert runner.buckets == flipped and not runner._held
    np.testing.assert_array_equal(got.column("label"), want.column("label"))
    np.testing.assert_array_equal(got.column("logits"), want.column("logits"))
    with pytest.raises(ConfigError, match="exceeds the grid"):
        runner.infer_sync(fat)  # the flipped grid's own windows are carved smaller
    monkeypatch.undo()
    after = asyncio.run(proc.process(batch))[0]
    np.testing.assert_allclose(after.column("logits"), want.column("logits"), atol=LOGIT_ATOL)


def test_bound_listener_keeps_the_commit_to_its_own_stream():
    port, _ = _runners(False, _host_params())
    tuner = _clocked(pt, port, False)
    buf = build_component("buffer", {"type": "memory", "capacity": 64, "timeout": "50ms",
                                     "coalesce": {"batch_buckets": [4, 8], "deadline": "20ms"}},
                          Resource())
    tuner.bind_listener(buf)
    tuner.bind_listener(buf)
    foreign = MicroBatchCoalescer([4, 8])
    bucket_cap_bus().register(foreign)
    _serve(port, tuner, [np.full(8, 12)] * 12, False)
    rep = asyncio.run(tuner.run_cycle(force=True))
    assert rep["action"] == "committed"
    assert buf._deadline_s == pytest.approx(rep["proposal"]["shape"]["deadline_ms"] / 1e3,
                                            abs=1e-6)
    assert buf._coalescer.buckets == (4, 8) and buf._deadline_s != 0.02
    assert foreign.buckets == (4, 8) and foreign.token_budget is None


# -- the engine and a stream ---------------------------------------------------------


class GatedInput(Input):
    """Batches of fixed texts in order; at each gate (a row index, the end
    of the texts included) it waits until the gate's event is set."""

    def __init__(self, texts: list[bytes], batch: int, gates: tuple[int, ...]):
        self.texts, self.batch = texts, batch
        self.gates = {g: asyncio.Event() for g in gates}
        self.pos = 0

    async def connect(self) -> None:
        pass

    async def read(self):
        if self.pos in self.gates:
            await self.gates[self.pos].wait()
        if self.pos >= len(self.texts):
            raise EndOfInput()
        end = min([self.pos + self.batch, len(self.texts)]
                  + [g for g in self.gates if g > self.pos])
        out = MessageBatch.new_binary(self.texts[self.pos:end])
        self.pos = end
        return out, NoopAck()

    async def close(self) -> None:
        pass


class Sink(Output):
    def __init__(self):
        self.rows: list[bytes] = []

    async def connect(self) -> None:
        pass

    async def write(self, batch) -> None:
        self.rows.extend(batch.to_binary())

    async def close(self) -> None:
        pass


def _engine_cfg(tuner, packed: bool = True) -> dict:
    proc = {"type": "gpu_inference", "model": "bert_classifier",
            "model_config": {**TINY_BERT, "max_positions": 64}, "max_seq": 64,
            "batch_buckets": [4, 8], "seq_buckets": [32, 64], "device": "cpu",
            "warmup": True, "packing": packed, "tuner": tuner}
    buffer = {"type": "memory", "capacity": 64, "timeout": "5ms",
              "coalesce": {"batch_buckets": [4, 8], "deadline": "20ms",
                           **({"token_budget": 256, "max_row_tokens": 64} if packed else {})}}
    return {"health_check": {"enabled": True, "host": "127.0.0.1", "port": 0},
            "streams": [{"name": "s", "input": {"type": "generate", "payload": "x"},
                         "buffer": buffer,
                         "pipeline": {"thread_num": 2, "processors": [
                             {"type": "fault", "faults": [], "inner": proc}]},
                         "output": {"type": "drop"}}]}


def _texts(seed: int, n: int, lo: int, hi: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [b" ".join(b"w%d" % w for w in rng.integers(0, 500, size=int(k)))
            + b" #%d" % (seed * 100000 + i)
            for i, k in enumerate(rng.integers(lo, hi + 1, size=n))]


def test_admin_tune_statuses_and_health_keys_match_jax():
    engine = Engine(EngineConfig.from_mapping(_engine_cfg(
        {"interval": 0, "min_samples": 8, "min_improvement": 0.005})))
    stream = engine.build()[0]
    texts = _texts(1, 160, 1, 8) + _texts(2, 160, 30, 50)
    stream.input = GatedInput(texts, 16, gates=(160, 320))
    stream.output = sink = Sink()
    runner, tuner = stream.pipeline.processors[0].runner, stream.tuners()[0]
    jax_report_keys = set(jt.ShapeTuner(_runners(False, _host_params())[1],
                                        model="bert_classifier").report())

    async def go():
        task = asyncio.create_task(engine.run())
        try:
            while engine.health_port is None or len(sink.rows) < 160:
                await asyncio.sleep(0.02)
            port = engine.health_port
            assert (await _http(port, "POST", "/admin/tune", raw=b"}{"))[0] == 400
            assert (await _http(port, "POST", "/admin/tune", raw=b"[1]"))[0] == 400
            assert (await _http(port, "POST", "/admin/tune", {"stream": "nope"}))[0] == 404
            assert (await _http(port, "GET", "/admin/tune"))[0] == 405
            status, body = await _http(port, "POST", "/admin/tune")
            assert status == 200 and body["ok"], body
            assert body["results"]["s"][0]["action"] == "committed"
            status, body = await _http(port, "POST", "/admin/tune", {"stream": "s"})
            assert status == 200 and body["results"]["s"][0]["action"] == "rejected"
            status, body = await _http(port, "GET", "/health")
            rep = body["stream_health"]["s"]["tuner"][0]
            assert set(rep) - {"last_decision"} == jax_report_keys - {"jax_cache"} | {"graphs"}
            assert rep["commits"] == 1 and rep["graphs"] == runner.graph_counts()
            grid = runner.buckets
            stream.input.gates[160].set()
            while len(sink.rows) < 320:
                await asyncio.sleep(0.02)
            tuner.inject_fault("probe_fail")
            status, body = await _http(port, "POST", "/admin/tune")
            rep = body["results"]["s"][0]
            assert status == 409 and not body["ok"] and "rolled back" in rep["error"], body
            assert runner.buckets == grid
        finally:
            for gate in stream.input.gates.values():
                gate.set()
            await task

    asyncio.run(go())
    assert sink.rows == texts


def test_shifting_stream_commits_once_and_keeps_every_row_in_order():
    """A few hundred rows, short then long, through the packed stream with
    the tuner: a cycle forced at the shift commits a grid that hugs the
    long mix, nothing is captured on the path after warmup, and every row
    arrives once, in order."""
    cfg = _engine_cfg({"interval": 0, "window": 128})
    engine = Engine(EngineConfig.from_mapping(cfg))
    stream = engine.build()[0]
    texts = _texts(3, 192, 2, 10) + _texts(4, 192, 36, 60)
    stream.input = GatedInput(texts, 16, gates=(320,))
    stream.output = sink = Sink()
    runner = stream.pipeline.processors[0].runner
    tuner = stream.tuners()[0]

    async def go():
        task = asyncio.create_task(engine.run())
        try:
            while len(sink.rows) < 320:
                await asyncio.sleep(0.02)
            captures = runner.captures
            return await tuner.run_cycle(force=True), captures
        finally:
            stream.input.gates[320].set()
            await task

    rep, captures = asyncio.run(go())
    assert rep["action"] == "committed" and tuner.commits == 1
    assert runner.buckets.seq_buckets[0] > 32 and runner.captures == captures
    assert stream.buffer._coalescer.token_budget == rep["proposal"]["shape"]["token_budget"]
    assert sink.rows == texts and stream.errors == 0
