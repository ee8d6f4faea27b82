"""The port's self-healing layer (``tpu/health.py``, ``tpu/serving_core.py``,
the OOM cap of ``tpu/bucketing.py`` and the runner's lifecycle) on the CPU,
against the JAX package: the health state machine driven through the same
marks on a fake clock, the cap bus and the coalescer cap through the same
calls, and the runner's deadline, rebuild and OOM scenarios of
``tests/test_selfheal.py`` ending in the same states."""

import asyncio
import threading
import time

import jax
import numpy as np
import pytest
import torch

from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.tpu import health as jax_health
from arkflow_tpu.tpu.bucketing import BucketPolicy as JaxBucketPolicy
from arkflow_tpu.tpu.bucketing import MicroBatchCoalescer as JaxCoalescer
from arkflow_tpu.tpu.bucketing import bucket_cap_bus as jax_bus
from arkflow_tpu.tpu.runner import ModelRunner as JaxModelRunner
from arkflow_tpu_torch.components import Resource, ensure_plugins_loaded
from arkflow_tpu_torch.components.registry import build_component
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError, RunnerDead, StepDeadlineExceeded
from arkflow_tpu_torch.tpu import health as port_health
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy, MicroBatchCoalescer, bucket_cap_bus
from arkflow_tpu_torch.tpu.compiled_step import CompiledStep, _first_oom
from arkflow_tpu_torch.tpu.health import (DEAD, DEGRADED, HEALTHY, UNHEALTHY, HealthConfig,
                                          RunnerHealth)
from arkflow_tpu_torch.tpu.runner import ModelRunner
from arkflow_tpu_torch.tpu.serving_core import InjectedOom, ServingRunnerCore, is_oom_error
from tests.test_torch_runner import _packed_layout
from tests.test_tpu_layer import TINY_BERT

ensure_plugins_loaded()

FAST = dict(probe_backoff_s=0.05, probe_backoff_cap_s=0.2)
#: a step deadline no warm tiny step misses on a loaded test host, and a
#: chaos hang that always does
DEADLINE, HANG = 1.0, 2.0


@pytest.fixture(autouse=True)
def _reset_cap_buses():
    """The cap buses are process-wide: no cap outlives its test."""
    yield
    bucket_cap_bus().reset()
    jax_bus().reset()


@pytest.fixture(scope="module")
def host():
    fam = jax_get_model("bert_classifier")
    return jax.device_get(fam.init(jax.random.PRNGKey(3), fam.make_config(**TINY_BERT)))


def _inputs(n=3, seq=16, seed=0):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(1, 512, (n, seq)).astype(np.int32),
            "attention_mask": np.ones((n, seq), np.int32)}


def _runner(host, **kw):
    kw.setdefault("buckets", BucketPolicy((2, 4), (16,)))
    kw.setdefault("health_config", HealthConfig(**FAST))
    return ModelRunner("bert_classifier", TINY_BERT, device="cpu",
                       host_params=params_from_jax(host), **kw)


# -- the state machine, against the JAX package's --------------------------


#: (action, argument) steps applied to both machines on one fake clock
SCRIPT = [("degraded", "cap"), ("success", None), ("unhealthy", "hang"), ("advance", 0.5),
          ("try_probe", None), ("advance", 0.6), ("try_probe", None), ("try_probe", None),
          ("join", None), ("join", None), ("success", None), ("unhealthy", "i1"),
          ("unhealthy", "i2"), ("advance", 1.9), ("join", None), ("advance", 0.2),
          ("join", None), ("join", None), ("unhealthy", "failed probe"), ("corrupt", "sdc"),
          ("success", None), ("unhealthy", "x"), ("repaired", None), ("unhealthy", "a"),
          ("unhealthy", "b"), ("repaired", None), ("success", None)]


def _drive(module, dead_after: int) -> list:
    now = [100.0]
    h = module.RunnerHealth(module.HealthConfig(probe_backoff_s=1.0, probe_backoff_cap_s=4.0,
                                                dead_after=dead_after), clock=lambda: now[0])
    trace = []
    for action, arg in SCRIPT:
        out = None
        if action == "advance":
            now[0] += arg
        elif action == "try_probe":
            out = h.try_begin_probe()
        elif action == "join":
            out = h.join_or_begin_probe()
        elif action == "repaired":
            out = h.mark_repaired()
        elif action == "success":
            h.mark_success()
        else:
            getattr(h, f"mark_{action}")(arg)
        trace.append((h.state, out, h.available(), h.report()))
    return trace


@pytest.mark.parametrize("dead_after", [0, 3, 8])
def test_health_state_machine_matches_jax(dead_after):
    assert _drive(jax_health, dead_after) == _drive(port_health, dead_after)


def test_health_state_machine_transitions():
    now = [100.0]
    h = RunnerHealth(HealthConfig(probe_backoff_s=1.0, probe_backoff_cap_s=4.0, dead_after=3),
                     clock=lambda: now[0])
    h.mark_degraded("bucket capped")
    assert h.state == DEGRADED and h.available()
    h.mark_success()
    h.mark_unhealthy("hung step")
    assert h.state == UNHEALTHY and not h.available()
    assert h.seconds_until_probe() == pytest.approx(1.0)
    now[0] += 1.1
    assert h.try_begin_probe() and not h.try_begin_probe()
    assert h.join_or_begin_probe()  # the claimed batch itself joins
    assert h.probing and not h.available()
    h.mark_success()
    assert h.state == HEALTHY and not h.probing
    for i in range(3):
        h.mark_unhealthy(f"i{i}")
    assert h.state == DEAD and not h.try_begin_probe()
    h.mark_success()
    assert h.state == DEAD and not h.mark_repaired()


def test_failed_generic_probe_releases_claim_and_rearms_backoff():
    now = [0.0]
    h = RunnerHealth(HealthConfig(probe_backoff_s=1.0, probe_backoff_cap_s=8.0, dead_after=0),
                     clock=lambda: now[0])
    h.mark_unhealthy("hang")
    now[0] = 1.1
    assert h.try_begin_probe()
    h.mark_unhealthy("step failed: boom")
    assert not h.probing and not h.try_begin_probe()  # backoff re-armed (2s)
    now[0] = 3.3
    assert h.try_begin_probe()


def test_join_gate_admits_exactly_one_handed_off_batch():
    now = [0.0]
    h = RunnerHealth(HealthConfig(probe_backoff_s=1.0), clock=lambda: now[0])
    h.mark_unhealthy("hang")
    now[0] = 1.1
    assert h.try_begin_probe()
    assert h.join_or_begin_probe()
    assert not h.join_or_begin_probe() and not h.join_or_begin_probe()
    h.mark_success()
    assert h.join_or_begin_probe()


@pytest.mark.parametrize("cfg", [None, {"probe_backoff": "100ms", "dead_after": 0},
                                 {"probe_backoff": "0s"}, {"dead_after": -1}, [1, 2],
                                 {"probe_backoff_cap": "2s", "dead_after": 2}])
def test_health_config_validation_matches_jax(cfg):
    try:
        want = jax_health.HealthConfig.from_config(cfg)
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            HealthConfig.from_config(cfg)
        assert str(got.value) == str(e)
        return
    got = HealthConfig.from_config(cfg)
    assert (got.probe_backoff_s, got.probe_backoff_cap_s, got.dead_after) == (
        want.probe_backoff_s, want.probe_backoff_cap_s, want.dead_after)


def test_health_never_dead_when_dead_after_zero():
    h = RunnerHealth(HealthConfig(probe_backoff_s=0.1, probe_backoff_cap_s=1.0, dead_after=0))
    for _ in range(50):
        h.mark_unhealthy("x")
    assert h.state == UNHEALTHY and h.seconds_until_probe() <= 1.0


# -- the OOM cap: policy, coalescer, bus ------------------------------------


def test_bucket_policy_capped():
    pol = BucketPolicy((4, 8, 16), (32,))
    assert pol.capped(16).batch_buckets == (4, 8)
    assert pol.capped(5).batch_buckets == (4,)
    assert pol.capped(16).seq_buckets == (32,)
    assert pol.capped(4) is None


def test_cap_sequence_matches_jax():
    """The same registrations and announcements on both buses leave both
    sets of coalescers on the same grids, budgets and standing cap."""
    calls = [("register", [2, 4, 8], None), ("register", [4, 16], 64), ("announce", 8),
             ("announce", 16), ("register", [2, 4, 8], 40), ("announce", 3), ("announce", 1),
             ("register", [8, 16], None)]

    def run(bus, coalescer_cls):
        made, trace = [], []
        for call in calls:
            if call[0] == "register":
                c = coalescer_cls(call[1], token_budget=call[2])
                bus.register(c)
                made.append(c)
            else:
                bus.announce(call[1])
            trace.append((bus.cap, [(c.buckets, c.target, c.token_budget) for c in made]))
        return trace

    assert run(bucket_cap_bus(), MicroBatchCoalescer) == run(jax_bus(), JaxCoalescer)


def test_memory_buffer_coalescer_registers_with_bus():
    buf = build_component("buffer", {"type": "memory", "capacity": 64, "timeout": "5ms",
                                     "coalesce": {"batch_buckets": [2, 4], "deadline": "5ms"}},
                          Resource())
    bucket_cap_bus().announce(2)
    assert buf._coalescer.target == 2
    late = build_component("buffer", {"type": "memory", "capacity": 64, "timeout": "5ms",
                                      "coalesce": {"batch_buckets": [2, 4], "deadline": "5ms"}},
                           Resource())
    assert late._coalescer.target == 2  # the standing cap reaches late registrations


# -- OOM classification, chaos hooks and the core ----------------------------


@pytest.mark.parametrize("err,oom", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`"),
     True),
    (InjectedOom(), True), (MemoryError(), True),
    (RuntimeError("RESOURCE_EXHAUSTED: while allocating"), True),
    (RuntimeError("Out of memory allocating 2.1G"), True),
    (RuntimeError("boom"), False), (RuntimeError("shape mismatch"), False),
    (ValueError("zoom lens"), False),
])
def test_is_oom_error(err, oom):
    assert is_oom_error(err) is oom


def test_first_oom_finds_the_allocator_error_in_the_chain():
    oom = torch.cuda.OutOfMemoryError("out of memory")
    try:
        try:
            raise oom
        except torch.cuda.OutOfMemoryError:
            raise RuntimeError("operation failed due to a previous error during capture")
    except RuntimeError as e:
        assert _first_oom(e) is oom
    plain = RuntimeError("x")
    assert _first_oom(plain) is plain


def test_core_chaos_and_validation():
    core = ServingRunnerCore(name="t", step_deadline_s=0.5)
    assert core.step_deadline_first_s == pytest.approx(5.0)  # 10x by default
    core.inject_step_fault("oom")
    with pytest.raises(InjectedOom):
        core.apply_chaos()
    core.apply_chaos()  # one-shot: nothing armed now
    core.inject_step_fault("sdc")
    out = core.corrupt_outputs({"logits": np.array([[1.0, -2.0]], np.float32),
                                "label": np.array([0]), "t": torch.tensor([[0.5, 1.5]])})
    assert out["logits"].tolist() == [[-1.0, 2.0]] and out["label"].tolist() == [1]
    assert out["t"].tolist() == [[-0.5, -1.5]]
    core.clear_sdc()
    assert core.corrupt_outputs({"x": np.ones(2)})["x"].tolist() == [1.0, 1.0]
    with pytest.raises(ConfigError):
        core.inject_step_fault("explode")
    with pytest.raises(ConfigError):
        ServingRunnerCore(name="t", step_deadline_s=0.0)
    with pytest.raises(ConfigError):
        ServingRunnerCore(name="t", step_deadline_s=1.0, step_deadline_first_s=-1.0)


def test_core_gate_rejects_dead_and_corrupt_and_classifies_failures():
    core = ServingRunnerCore(name="t", health_config=HealthConfig(dead_after=1))
    core.note_external_failure(StepDeadlineExceeded("missed"))
    core.note_external_failure(RuntimeError("CUDA out of memory"))
    core.note_external_failure(RunnerDead("gone"))
    assert core.health.state == HEALTHY  # the step marked these itself
    core.health.mark_corrupt("proven")
    with pytest.raises(RunnerDead, match="CORRUPT"):
        core.heal_gate_sync()
    core.health.mark_repaired()
    core.note_external_failure(RuntimeError("boom"))
    assert core.health.state == DEAD
    with pytest.raises(RunnerDead, match="DEAD"):
        asyncio.run(core.heal_gate())


def test_failed_capture_leaves_no_entry():
    """A first step that raises (here on the CPU path; on CUDA a capture)
    adds no entry: the next step of the key starts anew."""
    step = CompiledStep(torch.device("cpu"))
    calls = []

    def fn(x):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return {"y": x + 1}

    with pytest.raises(torch.cuda.OutOfMemoryError):
        step.run("k", fn, {"x": torch.zeros(2)})
    assert "k" not in step and step.captures == 0
    out = step.run("k", fn, {"x": torch.zeros(2)})
    assert out.out["y"].tolist() == [1.0, 1.0] and "k" in step and step.captures == 1


# -- the runner: deadlines, rebuild, zombies ---------------------------------


def test_deadline_miss_marks_unhealthy_then_probe_recovers(host):
    r = _runner(host, step_deadline_s=DEADLINE, step_deadline_first_s=30.0)
    r.warmup()
    ref = r.infer_sync(_inputs())
    compiled0, captures0 = r._compiled, r.captures
    r.inject_step_fault("hang", HANG)
    with pytest.raises(StepDeadlineExceeded):
        asyncio.run(r.infer(_inputs()))
    assert r.health.state == UNHEALTHY and r.deadline_misses == 1 and r.core.zombies == 1
    out = asyncio.run(asyncio.wait_for(r.infer(_inputs()), 30))
    np.testing.assert_array_equal(out["logits"], ref["logits"])
    assert r.health.state == HEALTHY and r.rebuilds == 1
    # the probe ran on a new CompiledStep holding the warmed keys again
    assert r._compiled is not compiled0 and r.captures == captures0 + len(compiled0)
    end = time.monotonic() + 10
    while r.core.zombies and time.monotonic() < end:
        time.sleep(0.02)
    assert r.core.zombies == 0


def test_deadline_miss_sync_path(host):
    r = _runner(host, step_deadline_s=DEADLINE, step_deadline_first_s=30.0)
    r.warmup()
    r.inject_step_fault("hang", HANG)
    with pytest.raises(StepDeadlineExceeded):
        r.infer_sync(_inputs())
    assert r.health.state == UNHEALTHY
    out = r.infer_sync(_inputs())  # waits the backoff, rebuilds, probes, recovers
    assert out["logits"].shape == (3, 2) and r.health.state == HEALTHY and r.rebuilds == 1


def test_first_step_deadline_covers_a_key_without_a_graph(host):
    r = _runner(host, step_deadline_s=0.5)
    assert r.core.step_deadline_first_s == pytest.approx(5.0)
    r.inject_step_fault("hang", 1.0)
    out = asyncio.run(r.infer(_inputs()))  # no graph yet: the 5.0 s budget
    assert out["logits"].shape == (3, 2) and r.deadline_misses == 0
    r.inject_step_fault("hang", 1.0)
    with pytest.raises(StepDeadlineExceeded):  # the key has a graph now: 0.5 s
        asyncio.run(r.infer(_inputs()))


def test_zombie_keeps_its_staging_set_and_does_not_block_the_probe(host):
    """The abandoned step holds its staging set until it ends; the probe
    runs (on a new CompiledStep) while the zombie still sleeps, and the
    zombie then finishes on the old one."""
    r = _runner(host, step_deadline_s=DEADLINE, step_deadline_first_s=30.0)
    r.warmup()
    released, stepped = [], []
    orig_release, orig_step = r._staging.release, r._step
    r._staging.release = lambda bufs: (released.append(bufs), orig_release(bufs))[1]
    r._step = lambda compiled, bufs, *a: (stepped.append(bufs), orig_step(compiled, bufs, *a))[1]
    r.inject_step_fault("hang", 3.0)
    with pytest.raises(StepDeadlineExceeded):
        r.infer_sync(_inputs())
    zombie_set, old = stepped[-1], r._compiled
    old_replays = sum(old.replays.values())
    r.infer_sync(_inputs())  # the probe
    # the probe (rebuild included) ended while the zombie still slept
    assert r.core.zombies == 1 and r._compiled is not old
    assert stepped[-1] is not zombie_set and zombie_set not in released
    end = time.monotonic() + 10
    while r.core.zombies and time.monotonic() < end:
        time.sleep(0.02)
    assert r.core.zombies == 0 and released[-1] is zombie_set
    assert sum(old.replays.values()) == old_replays + 1  # it ended on the old step


def test_zombie_holding_the_step_lock_does_not_block_the_probe(host):
    """A key's first step that misses ``step_deadline_first`` inside the
    ``CompiledStep`` lock (a slow capture or kernel build, not chaos): the
    probe's rebuild and step end while the zombie still holds the old
    lock. The probe's own first step and the rebuild's recapture each have
    the 2.5 s first-step budget, which a CPU shared with other test
    processes does not reach; the zombie sleeps past both."""
    r = _runner(host, step_deadline_s=2.0, step_deadline_first_s=2.5)
    slow_s, calls, forward = 10.0, [], r._forward

    def slow_first(**kw):
        if not calls:
            calls.append(time.monotonic())
            time.sleep(slow_s)
        return forward(**kw)

    r._forward = slow_first
    with pytest.raises(StepDeadlineExceeded):
        r.infer_sync(_inputs())
    old = r._compiled
    assert r.health.state == UNHEALTHY and old._lock.locked()
    out = r.infer_sync(_inputs())  # the probe: rebuild, then the key's first step
    assert time.monotonic() - calls[0] < slow_s
    assert out["logits"].shape == (3, 2) and r.health.state == HEALTHY and r.rebuilds == 1
    assert r.core.zombies == 1 and r._compiled is not old and old._lock.locked()
    end = time.monotonic() + slow_s
    while r.core.zombies and time.monotonic() < end:
        time.sleep(0.02)
    assert r.core.zombies == 0 and not old._lock.locked()


def test_failed_probe_releases_its_claim(host):
    r = _runner(host, step_deadline_s=DEADLINE, step_deadline_first_s=30.0)
    r.warmup()
    r.inject_step_fault("hang", HANG)
    with pytest.raises(StepDeadlineExceeded):
        r.infer_sync(_inputs())
    with pytest.raises(ConfigError, match="missing input"):
        r.infer_sync({"input_ids": _inputs()["input_ids"]})  # the probe fails
    assert r.health.state == UNHEALTHY and not r.health.probing
    assert r.infer_sync(_inputs())["logits"].shape == (3, 2)
    assert r.health.state == HEALTHY


def test_runner_dead_after_consecutive_incidents(host):
    r = _runner(host, step_deadline_s=DEADLINE, step_deadline_first_s=30.0,
                health_config=HealthConfig(probe_backoff_s=0.01, probe_backoff_cap_s=0.05,
                                           dead_after=2))
    r.infer_sync(_inputs())
    for _ in range(2):
        r.inject_step_fault("hang", HANG)
        with pytest.raises(StepDeadlineExceeded):
            r.infer_sync(_inputs())
    assert r.health.state == DEAD
    with pytest.raises(RunnerDead):
        r.infer_sync(_inputs())


def test_step_deadline_validation(host):
    with pytest.raises(ConfigError):
        _runner(host, step_deadline_s=0.0)
    with pytest.raises(ConfigError):
        _runner(host, step_deadline_s=1.0, step_deadline_first_s=-1.0)
    with pytest.raises(ConfigError):
        _runner(host).inject_step_fault("explode")


# -- the runner: OOM ---------------------------------------------------------


@pytest.mark.parametrize("sync", [False, True])
def test_oom_splits_to_smaller_bucket_and_caps_grid(host, sync):
    r = _runner(host)
    r.warmup()
    ref = r.infer_sync(_inputs())
    assert bucket_cap_bus().cap is None and r.bucket_cap == 4
    r.inject_step_fault("oom")
    out = r.infer_sync(_inputs()) if sync else asyncio.run(r.infer(_inputs()))
    np.testing.assert_array_equal(out["logits"], ref["logits"])
    assert r.buckets.batch_buckets == (2,) and r.bucket_cap == 2 and r.ooms == 1
    assert bucket_cap_bus().cap == 2 and r.health.state == HEALTHY
    assert r.health_report()["bucket_cap"] == 2


def test_oom_at_smallest_bucket_surfaces_and_marks_unhealthy(host):
    r = _runner(host, buckets=BucketPolicy((2,), (16,)))
    r.warmup()
    r.inject_step_fault("oom")
    with pytest.raises(InjectedOom):
        asyncio.run(r.infer(_inputs(n=2)))
    assert r.health.state == UNHEALTHY and r.ooms == 1


def test_packed_oom_caps_and_reraises(host):
    r = _runner(host, buckets=BucketPolicy((2, 4), (16,), example_scale=2), packed=True)
    _, layout = _packed_layout(0, 10, 16, 16)  # 4 rows: the top row bucket
    r.inject_step_fault("oom")
    with pytest.raises(InjectedOom):
        r.infer_sync(layout)
    assert r.ooms == 1 and r.bucket_cap < 4 and bucket_cap_bus().cap == r.bucket_cap
    assert r.health.state == DEGRADED


def test_probe_steps_pass_over_one_shot_chaos(host):
    """A verification step (golden probe, swap probe) leaves an armed hang
    or OOM to the next traffic step."""
    r = _runner(host)
    r.warmup()
    r.inject_step_fault("oom")
    r.infer_sync(_inputs(n=2), probe=True)
    assert r.ooms == 0
    r.infer_sync(_inputs())
    assert r.ooms == 1


@pytest.mark.parametrize("scenario", ["deadline", "oom"])
def test_lifecycle_scenarios_end_in_jax_states(host, scenario):
    """The same scenario on the JAX runner and on the port's ends in the
    same health state, bucket grid and counts."""
    kw = dict(step_deadline_s=DEADLINE, step_deadline_first_s=30.0) if scenario == "deadline" else {}
    jr = JaxModelRunner("bert_classifier", TINY_BERT, buckets=JaxBucketPolicy((2, 4), (16,)),
                        host_params=host, health_config=jax_health.HealthConfig(**FAST), **kw)
    pr = _runner(host, **kw)
    states = []
    for r in (jr, pr):
        r.warmup()
        if scenario == "deadline":
            r.inject_step_fault("hang", HANG)
            with pytest.raises(Exception, match="deadline"):
                r.infer_sync(_inputs())
            mid = r.health.state
            r.infer_sync(_inputs())
        else:
            r.inject_step_fault("oom")
            mid = None
            r.infer_sync(_inputs())
        states.append((mid, r.health.state, tuple(r.buckets.batch_buckets)))
    assert states[0] == states[1]
    assert (pr.deadline_misses, pr.rebuilds, pr.ooms) == (
        (1, 1, 0) if scenario == "deadline" else (0, 0, 1))


def test_concurrent_probe_waiters_admit_one_prober(host):
    """Several callers behind an UNHEALTHY gate: exactly one claims the
    probe; the others wait and then all succeed."""
    r = _runner(host, step_deadline_s=DEADLINE, step_deadline_first_s=30.0)
    r.warmup()
    r.inject_step_fault("hang", HANG)
    with pytest.raises(StepDeadlineExceeded):
        r.infer_sync(_inputs())
    results, errors = [], []

    def call():
        try:
            results.append(r.infer_sync(_inputs()))
        except Exception as e:  # noqa: BLE001 -- recorded for the assert
            errors.append(e)

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 4 and r.rebuilds == 1
    assert r.health.state == HEALTHY
