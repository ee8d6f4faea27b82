"""Overload admission against the JAX package's: ``runtime/overload.py``,
``runtime/respcache.py``, the pipeline's ``queue_size``, ``deadline_ms``,
``priority`` and ``overload`` keys, and the stream's shed paths.

Every case runs once through each package on the same inputs. The
controllers run on an injected clock (both modules' ``time`` replaced by
one ``FakeClock``), so their decisions, windows, states and ``report()``
are held exactly equal at every step of a seeded event trace; the stream
scenarios of ``tests/test_overload.py`` are held to the same payloads,
tags and counters. No count here depends on the wall clock's timing."""

import asyncio
import math
import time
import types
import uuid

import numpy as np
import pytest

from arkflow_tpu_torch.components import ensure_plugins_loaded

ensure_plugins_loaded()


def _jax_pkg():
    import arkflow_tpu.runtime.engine as engine_mod
    import arkflow_tpu.runtime.overload as overload
    import arkflow_tpu.runtime.respcache as respcache
    import arkflow_tpu.runtime.stream as stream_mod
    import arkflow_tpu.utils.rate_limiter as rate_limiter
    from arkflow_tpu import batch, config
    from arkflow_tpu.components import Ack, NoopAck
    from arkflow_tpu.components import ensure_plugins_loaded as load
    from arkflow_tpu.errors import ConfigError, EndOfInput, Overloaded
    from arkflow_tpu.plugins.buffer.memory import MemoryBuffer
    from arkflow_tpu.plugins.fault import schedule, wrappers
    from arkflow_tpu.plugins.input.memory import MemoryInput
    from arkflow_tpu.plugins.output.drop import DropOutput
    from arkflow_tpu.runtime import Pipeline, Stream, build_stream
    from arkflow_tpu.tpu import bucketing

    load()
    return types.SimpleNamespace(name="jax", **locals())


def _port_pkg():
    import arkflow_tpu_torch.runtime.engine as engine_mod
    import arkflow_tpu_torch.runtime.overload as overload
    import arkflow_tpu_torch.runtime.respcache as respcache
    import arkflow_tpu_torch.runtime.stream as stream_mod
    import arkflow_tpu_torch.utils.rate_limiter as rate_limiter
    from arkflow_tpu_torch import batch, config
    from arkflow_tpu_torch.components import Ack, NoopAck
    from arkflow_tpu_torch.errors import ConfigError, EndOfInput, Overloaded
    from arkflow_tpu_torch.plugins.buffer.memory import MemoryBuffer
    from arkflow_tpu_torch.plugins.fault import schedule, wrappers
    from arkflow_tpu_torch.plugins.input.memory import MemoryInput
    from arkflow_tpu_torch.plugins.output.drop import DropOutput
    from arkflow_tpu_torch.runtime.pipeline import Pipeline
    from arkflow_tpu_torch.runtime.stream import Stream, build_stream
    from arkflow_tpu_torch.tpu import bucketing

    return types.SimpleNamespace(name="port", **locals())


JAX, PORT = _jax_pkg(), _port_pkg()
PKGS = (JAX, PORT)


# -- harness ------------------------------------------------------------------


def uname(base: str) -> str:
    """Both packages' registries are process-global and key series by stream
    name: every controller and stream here gets a name of its own."""
    return f"{base}-{uuid.uuid4().hex[:8]}"


def run(coro, timeout: float = 20.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def both(fn, *args, **kw) -> dict:
    """``fn(pkg, ...)`` once per package; the port's result must equal
    JAX's. Returns the port's."""
    got = {pkg.name: fn(pkg, *args, **kw) for pkg in PKGS}
    assert got["port"] == got["jax"], (got["port"], got["jax"])
    return got["port"]


class FakeClock:
    """``time.monotonic`` (and ``time.time``) of the overload, cache and
    token-bucket modules, advanced by hand."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t

    def perf_counter(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    fake = types.SimpleNamespace(monotonic=c.monotonic, time=c.time, perf_counter=c.perf_counter)
    for pkg in PKGS:
        for mod in (pkg.overload, pkg.respcache, pkg.rate_limiter):
            monkeypatch.setattr(mod, "time", fake)
    return c


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


def ctrl_of(pkg, overload: dict, *, deadline_ms=None, priority=0, workers=1,
            max_window=None, name="ctl"):
    cfg = pkg.overload.OverloadConfig.from_config(overload, deadline_ms=deadline_ms,
                                                  priority=priority)
    return pkg.overload.OverloadController(cfg, name=uname(name), workers=workers,
                                           max_window=max_window)


def ack_log(pkg, log: list, redeliverable: bool = True):
    class LogAck(pkg.Ack):
        async def ack(self):
            log.append("ack")

        async def nack(self):
            log.append("nack")

    a = LogAck()
    a.redeliverable = redeliverable
    return a


def config_error(pkg, fn) -> str:
    with pytest.raises(pkg.ConfigError) as e:
        fn(pkg)
    return str(e.value)


# -- config ---------------------------------------------------------------------


def _pipeline(pkg, m: dict):
    return pkg.config.PipelineConfig.from_mapping(m)


def test_queue_size_default_and_override():
    def go(pkg):
        out = []
        for m in ({"thread_num": 3}, {"thread_num": 3, "queue_size": 5}):
            cfg = _pipeline(pkg, m)
            out.append((cfg.queue_size, cfg.effective_queue_size(), cfg.overload))
        return out

    assert both(go) == [(0, 12, None), (5, 5, None)]


@pytest.mark.parametrize("m", [
    {"queue_size": -1}, {"queue_size": True}, {"queue_size": 2.5},
    {"deadline_ms": 0}, {"deadline_ms": -5}, {"deadline_ms": True}, {"deadline_ms": "1s"},
    {"priority": 1.5}, {"priority": True},
    {"overload": "on"}, {"overload": {"max_window": "8"}}, {"overload": {"headroom": 0}},
    {"overload": {"headroom": 1.5}}, {"overload": {"decrease": 1.0}},
    {"overload": {"increase": 0}}, {"overload": {"min_window": 0}},
    {"overload": {"max_window": -1}}, {"overload": {"target_wait": "0s"}},
    {"overload": {"escalate_after": -1}}, {"overload": {"escalate_after": True}},
    {"overload": {"protect_priority": 0}},
    {"deadline_ms": 100, "priority": 2, "overload": {"protect_priority": 2}},
    {"overload": {"tenants": "x"}}, {"overload": {"tenants": {"max_tracked": 0}}},
], ids=lambda m: str(m))
def test_pipeline_refusals_match_jax(m):
    """Every refusal of the pipeline's overload keys raises JAX's message."""
    both(config_error, lambda pkg: _pipeline(pkg, {"processors": [], **m}))


def test_overload_disabled_by_default_enabled_by_deadline():
    def go(pkg):
        out = []
        for m in ({}, {"deadline_ms": 50}, {"deadline_ms": 50, "overload": False},
                  {"overload": {"max_window": 4}}, {"overload": True},
                  {"overload": {"enabled": False, "max_window": 4}}):
            ov = _pipeline(pkg, {"processors": [], **m}).overload
            out.append(None if ov is None else repr(ov))
        return out

    got = both(go)
    assert got[0] is None and "enabled=True" in got[1] and "enabled=False" in got[2]
    assert "enabled=False" in got[5]


def test_overload_knobs_parse_and_validate():
    m = {"protect_priority": 2, "max_window": 16, "min_window": 2, "headroom": 0.25,
         "target_wait": "40ms", "decrease": 0.7, "increase": 2, "interval": "0s",
         "escalate_after": 5}

    def go(pkg):
        cfg = pkg.overload.OverloadConfig.from_config(m, deadline_ms=80.0, priority=1)
        return repr(cfg), repr(cfg.shard_local())

    got = both(go)
    assert "interval_s=0.0" in got[0] and "target_wait_s=0.04" in got[0]


@pytest.mark.parametrize("tenants", [
    {"default_weight": 0}, {"default_weight": True}, {"max_tracked": 0},
    {"max_tracked": 1.5}, {"min_share": 0}, {"burst": "0s"}, {"per_tenant": "x"},
    {"per_tenant": {"a": "x"}}, {"per_tenant": {"a": {"weight": 0}}},
    {"per_tenant": {"a": {"rows_per_sec": -1}}}, {"default_quota": {"rows_per_sec": True}},
    {"default_quota": "x"}, {"token_field": ""}, {"token_field": 7}, {"token_bytes": 0},
    {"token_bytes": True}, "nope",
], ids=lambda m: str(m))
def test_tenant_policy_refusals_match_jax(tenants):
    both(config_error, lambda pkg: pkg.overload.TenantPolicy.from_config(tenants))


def test_tenant_policy_parse_matches_jax():
    m = {"default_weight": 2, "burst": "2s", "max_tracked": 8, "min_share": 2,
         "token_field": "text", "token_bytes": 4,
         "default_quota": {"rows_per_sec": 10},
         "per_tenant": {"premium": {"weight": 8, "rows_per_sec": 100, "tokens_per_sec": 1000},
                        "batch": {}}}

    def go(pkg):
        p = pkg.overload.TenantPolicy.from_config(m)
        return (repr(p), repr(p.without_quotas()), p.weight_of("batch"),
                p.quota_of("unknown").rows_per_sec, p.meters_tokens(),
                pkg.overload.TenantPolicy.from_config(True) is not None,
                pkg.overload.TenantPolicy.from_config(False))

    got = both(go)
    assert got[2] == 2.0 and got[3] == 10.0 and got[4] and got[6] is None


def test_cap_tenant_label_matches_jax():
    def go(pkg):
        cap = pkg.overload.cap_tenant_label
        tracked = {"a": 1, "b": 1}
        return [cap(None, tracked), cap("", tracked), cap("a", tracked, cap=2),
                cap("c", tracked, cap=2), cap("c", tracked, reserved=("c",), cap=2),
                cap("c", tracked, cap=3), pkg.overload.SHED_REASONS,
                pkg.overload.MAX_TENANT_LABELS]

    assert both(go)[:4] == ["default", "default", "a", "__other__"]


# -- the controller on a seeded event trace --------------------------------------------


TRACE_CONFIGS = {
    "deadline_escalate": ({"max_window": 8, "interval": "50ms", "escalate_after": 2}, 200.0, 0),
    "no_deadline": ({"max_window": 6, "target_wait": "80ms", "interval": "0s"}, None, 0),
    "min_window_band1": ({"max_window": 10, "min_window": 3, "protect_priority": 2,
                          "decrease": 0.7, "increase": 2, "interval": "20ms"}, 120.0, 1),
    "tenants_quotas": ({"max_window": 8, "interval": "30ms", "tenants": {
        "burst": "2s", "max_tracked": 3, "default_quota": {"rows_per_sec": 40},
        "per_tenant": {"a": {"weight": 4, "rows_per_sec": 100, "tokens_per_sec": 500},
                       "b": {"weight": 1, "tokens_per_sec": 80}}}}, 300.0, 0),
    "tenants_weights_only": ({"max_window": 12, "interval": "0s",
                              "tenants": {"min_share": 2, "per_tenant": {"a": {"weight": 3}}}},
                             None, 0),
}


def _trace(pkg, clock: FakeClock, key: str, seed: int) -> list:
    overload, deadline, priority = TRACE_CONFIGS[key]
    clock.t = 1000.0
    ctrl = ctrl_of(pkg, overload, deadline_ms=deadline, priority=priority, workers=2,
                   max_window=16, name="trace")
    rng = np.random.default_rng(seed)
    queued: list = []
    tenants = (None, "a", "b", "c", "d", "e")
    steps = []
    for _ in range(400):
        ev = rng.choice(["admit", "admit", "admit", "dequeue", "dequeue", "step", "advance",
                         "advance", "expire", "pause", "quota"])
        raw = tenants[int(rng.integers(len(tenants)))]
        label = ctrl.tenant_label(raw)
        out = None
        if ev == "admit":
            remaining = None if rng.random() < 0.3 else float(rng.uniform(-20.0, 400.0))
            rows, tokens = float(rng.integers(1, 24)), float(rng.uniform(0.0, 300.0))
            out = ctrl.admit(int(rng.integers(0, 3)), remaining, tenant=label, rows=rows,
                             tokens=tokens)
            if out is None:
                ctrl.on_enqueue(label)
                queued.append(label)
        elif ev == "dequeue" and queued:
            label = queued.pop(int(rng.integers(len(queued))))
            ctrl.on_dequeue(float(rng.uniform(0.0, 0.4)), clock.t, tenant=label)
            clock.t += float(rng.uniform(0.0, 0.05))
        elif ev == "step":
            ctrl.observe_step(float(rng.uniform(0.001, 0.2)))
        elif ev == "advance":
            clock.t += float(rng.exponential(0.3))
        elif ev == "expire":
            out = ctrl.expire(label)
        elif ev == "pause":
            out = (ctrl.should_pause(), ctrl.should_reject(), ctrl.retry_after_s())
        elif ev == "quota":
            out = ctrl.quota_retry_after_s(raw, rows=float(rng.integers(1, 5)),
                                           tokens=float(rng.uniform(0, 50)))
        steps.append((str(ev), out, ctrl.window, ctrl.state, ctrl.admit_floor, ctrl.queued,
                      ctrl.signals(), ctrl.report()))
    return steps


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("key", sorted(TRACE_CONFIGS))
def test_controller_trace_matches_jax_at_every_step(clock, key, seed):
    """Decisions, window, state, brownout floor, queue depth, ``signals()``
    and ``report()`` after each of 400 seeded events (admissions with
    deadlines, bands, tenants, rows and tokens; dequeues; step times; clock
    advances; expiries; pause and quota probes), held exactly equal."""
    steps = both(_trace, clock, key, seed)
    verdicts = [s[1] for s in steps if s[0] == "admit"]
    assert None in verdicts and any(isinstance(v, str) for v in verdicts)
    if key.startswith("tenants"):
        assert "tenants" in steps[-1][-1]
    if key == "tenants_quotas":
        assert "__other__" in steps[-1][-1]["tenants"]
        assert seed != 0 or "quota" in verdicts


def test_aimd_and_brownout_sequence_matches_jax(clock):
    """JAX's AIMD test, step by step: over-budget waits halve the window to
    the floor, escalate the admit floor, then healthy waits relax the floor
    before the window regrows one batch an interval."""
    def go(pkg):
        clock.t = 1000.0
        ctrl = ctrl_of(pkg, {"max_window": 8, "interval": "0s", "escalate_after": 2},
                       deadline_ms=100.0)
        out = []
        for _ in range(6):
            ctrl.on_dequeue(0.2, clock.t)
            out.append((ctrl.window, ctrl.state, ctrl.admit_floor))
        for _ in range(70):  # the slow samples age out of the 64-sample p50
            ctrl.on_dequeue(0.0, clock.t)
            out.append((ctrl.window, ctrl.state, ctrl.admit_floor))
        return out

    got = both(go)
    assert got[0] == (4.0, 2, None) and got[4][2] == 1 and got[-1] == (8.0, 0, None)


def test_idle_recovery_relaxes_brownout_matches_jax(clock):
    def go(pkg):
        clock.t = 1000.0
        ctrl = ctrl_of(pkg, {"max_window": 2, "min_window": 2, "interval": "0s",
                             "escalate_after": 1}, deadline_ms=100.0)
        ctrl.on_dequeue(0.5, clock.t)
        ctrl.on_dequeue(0.5, clock.t)
        # the brownout floor sheds band 0; the slow samples make the
        # deadline shed first while they last
        seen = [ctrl.admit_floor, ctrl.admit(0, 500.0), ctrl.admit(0, None)]
        clock.t += 1.0  # idle past the recovery period: samples and floor go
        seen += [ctrl.admit(0, 500.0), ctrl.report()["state"], ctrl.admit_floor]
        return seen

    assert both(go) == [1, "deadline", "priority", None, "admit", None]


def test_predicted_wait_and_retry_after_match_jax(clock):
    def go(pkg):
        ctrl = ctrl_of(pkg, {"max_window": 8}, deadline_ms=100.0, workers=2)
        ctrl.observe_step(0.04)
        for _ in range(4):
            ctrl.on_enqueue()
        first = (ctrl.predicted_wait_s(), ctrl.admit(0, 60.0), ctrl.admit(0, 200.0),
                 ctrl.estimated_drain_s())
        ctrl.state = pkg.overload.STATE_SHED
        for _ in range(5):
            ctrl.on_enqueue()
        return first + (ctrl.should_pause(), ctrl.should_reject(), ctrl.retry_after_s())

    got = both(go)
    assert got[0] == pytest.approx(0.08) and got[1] == "deadline" and got[2] is None
    assert got[4] is True


def test_wait_capacity_wakes_on_dequeue():
    async def go(pkg):
        ctrl = ctrl_of(pkg, {"max_window": 1}, deadline_ms=100.0)
        ctrl.on_enqueue()
        t0 = time.perf_counter()
        waiter = asyncio.ensure_future(ctrl.wait_capacity(5.0))
        await asyncio.sleep(0.01)
        ctrl.on_dequeue(0.0)
        await waiter
        return time.perf_counter() - t0 < 1.0

    assert all(run(go(pkg)) for pkg in PKGS)


def test_overloaded_error_carries_retry_after():
    def go(pkg):
        e = pkg.Overloaded("tenant quota exceeded", retry_after_s=2.5)
        return (str(e), e.retry_after_s, pkg.Overloaded().retry_after_s,
                isinstance(e, pkg.ConfigError.__mro__[1]))

    assert both(go) == ("tenant quota exceeded", 2.5, 1.0, True)


# -- FairQueue ---------------------------------------------------------------------------


class _Item:
    def __init__(self, tenant, n):
        self.tenant = tenant
        self.n = n


class _Sentinel:
    """No ``tenant``: the control lane."""


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fairqueue_order_matches_jax(seed):
    """Seeded interleavings of puts and gets over lanes of weights 0.5..8
    and control items: the dequeue order is JAX's."""
    async def go(pkg):
        ctrl = ctrl_of(pkg, {"max_window": 8, "tenants": {"per_tenant": {
            "a": {"weight": 8}, "b": {"weight": 2}, "c": {"weight": 0.5}}}})
        q = pkg.overload.FairQueue(ctrl, maxsize=1000)
        rng = np.random.default_rng(seed)
        order, n = [], 0
        for _ in range(300):
            if rng.random() < 0.6:
                t = ["a", "b", "c", "d"][int(rng.integers(4))]
                item = _Sentinel() if rng.random() < 0.05 else _Item(t, n)
                n += 1
                await q.put(item)
            elif q.qsize():
                it = await q.get()
                order.append(("ctl", None) if isinstance(it, _Sentinel) else (it.tenant, it.n))
        while q.qsize():
            it = await q.get()
            order.append(("ctl", None) if isinstance(it, _Sentinel) else (it.tenant, it.n))
        return order

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"] and len(got["port"]) > 100


def test_fairqueue_weights_control_lane_and_backpressure():
    async def go(pkg):
        ctrl = ctrl_of(pkg, {"tenants": {"per_tenant": {"big": {"weight": 2}}}})
        q = pkg.overload.FairQueue(ctrl, maxsize=64)
        for i in range(6):
            await q.put(_Item("big", i))
        for i in range(3):
            await q.put(_Item("small", i))
        await q.put(_Sentinel())
        order = [getattr(await q.get(), "tenant", "ctl") for _ in range(10)]
        small = pkg.overload.FairQueue(ctrl, maxsize=1)
        await small.put(_Item("a", 0))
        blocked = asyncio.ensure_future(small.put(_Item("a", 1)))
        await asyncio.sleep(0.02)
        was_blocked = not blocked.done()
        await small.get()
        await asyncio.wait_for(blocked, 1.0)
        await asyncio.wait_for(small.put(_Sentinel()), 1.0)  # control items never block
        return order, was_blocked, small.qsize()

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["big", "big", "small"] * 3 + ["ctl"] and got["port"][1]


# -- the response cache ---------------------------------------------------------------


def test_cache_lru_ttl_epoch_and_report_match_jax(clock):
    def go(pkg):
        clock.t = 1000.0
        c = pkg.respcache.ResponseCache(capacity=2, ttl_s=5.0, name=uname("lru"))
        out = []
        c.store(b"a", 1)
        c.store(b"b", 2)
        out.append(c.lookup(b"a"))
        c.store(b"c", 3)  # evicts b
        out += [c.lookup(b"b"), len(c)]
        clock.t += 6.0
        out += [c.lookup(b"a"), len(c), c.report()]
        c.store(b"d", 4)
        c.bump_epoch()
        out += [c.epoch, len(c), c.report()]
        return out

    got = both(go)
    assert got[:3] == [1, None, 2] and got[3] is None and got[-2:][0] == 0


def test_cache_collapse_error_and_epoch_match_jax():
    """Five concurrent duplicates make one compute (four collapsed), a hit
    follows; a failed compute reaches every waiter and caches nothing; a
    post-swap duplicate misses (the epoch test of ``tests/test_hotswap.py``)."""
    async def go(pkg):
        c = pkg.respcache.ResponseCache(capacity=8, name=uname("collapse"))
        calls = []

        async def compute():
            calls.append(1)
            await asyncio.sleep(0.02)
            return {"y": len(calls)}

        res = await asyncio.gather(*[c.get_or_compute(b"k", compute, tenant="acme")
                                     for _ in range(5)])
        res.append(await c.get_or_compute(b"k", compute, tenant="acme"))

        async def boom():
            calls.append(1)
            await asyncio.sleep(0.01)
            raise RuntimeError("step failed")

        errs = await asyncio.gather(*[c.get_or_compute(b"e", boom) for _ in range(3)],
                                    return_exceptions=True)
        c.bump_epoch()
        res.append(await c.get_or_compute(b"k", compute))
        res.append(await c.get_or_compute(b"k", compute))
        return (res, [type(e).__name__ for e in errs], len(calls), c.report(),
                {t: int(h.value) for t, h in c._tenant_hits.items()})

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    res, errs, calls, report, tenant_hits = got["port"]
    assert res == [{"y": 1}] * 6 + [{"y": 3}] * 2 and errs == ["RuntimeError"] * 3
    assert calls == 3 and report["collapsed"] == 6 and report["epoch"] == 1
    assert tenant_hits == {"acme": 5, "default": 3}  # 2 collapsed failures + 1 hit


def test_cache_tenant_hit_labels_cap_with_the_policy():
    async def go(pkg):
        c = pkg.respcache.ResponseCache(capacity=64, name=uname("labels"))
        c.set_tenant_policy(pkg.overload.TenantPolicy.from_config(
            {"max_tracked": 2, "per_tenant": {"vip": {}}}))

        async def compute():
            return 1

        await c.get_or_compute(b"k", compute)
        for t in ("a", "b", "c", "d", "vip"):
            await c.get_or_compute(b"k", compute, tenant=t)
        return {t: int(h.value) for t, h in c._tenant_hits.items()}

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"] == {"a": 1, "b": 1, "__other__": 2, "vip": 1}


@pytest.mark.parametrize("cfg", [None, False, True, {"capacity": 8, "ttl": "30s"},
                                 {"capacity": 0}, {"capacity": True}, {"ttl": "0s"}, "yes", 7],
                         ids=lambda c: str(c))
def test_response_cache_config_matches_jax(cfg):
    def go(pkg):
        try:
            return ("ok", pkg.respcache.parse_response_cache_config(cfg))
        except pkg.ConfigError as e:
            return ("error", str(e))

    both(go)


def test_response_cache_validates_through_fault_wrappers():
    def go(pkg, proc_type):
        return config_error(pkg, lambda p: p.config.StreamConfig.from_mapping({
            "input": {"type": "memory", "messages": ["a"]}, "output": {"type": "drop"},
            "pipeline": {"processors": [{"type": "fault", "inner": {
                "type": proc_type, "model": "m", "response_cache": {"capacity": -1}}}]}}))

    assert go(PORT, "gpu_inference") == go(JAX, "tpu_inference")


# -- stream scenarios (tests/test_overload.py) -------------------------------------------


def stale_input(pkg, messages, every_other=True):
    class StaleStampingInput(pkg.MemoryInput):
        """Stamps alternate batches with an absolute deadline 10 s past."""

        def __init__(self):
            super().__init__(messages)
            self._n = 0

        async def read(self):
            batch, ack = await super().read()
            i, self._n = self._n, self._n + 1
            if not every_other or i % 2 == 0:
                batch = batch.with_deadline_ms(time.time() * 1000.0 - 10_000)
            return batch, ack

    return StaleStampingInput()


def test_stream_routes_shed_batches_to_error_output_tagged():
    def go(pkg):
        msgs = [f"row{i}".encode() for i in range(8)]
        sink, shed = collect(pkg), collect(pkg)
        stream = pkg.Stream(stale_input(pkg, msgs), pkg.Pipeline([]), sink, error_output=shed,
                            thread_num=1, name=uname("shed-eo"),
                            overload=pkg.overload.OverloadConfig(enabled=True))
        run(stream.run(asyncio.Event()))
        tags = [(b.get_meta("__meta_ext_error"), b.get_meta("__meta_ext_shed_reason"))
                for b in shed.batches]
        return (sorted(payloads_of(sink)), sorted(payloads_of(shed)), tags,
                stream.m_batches_in.value, stream.overload.m_shed["deadline"].value,
                stream.overload.report()["shed"])

    delivered, shed, tags, offered, deadline_sheds, _ = both(go)
    assert delivered == [f"row{i}".encode() for i in range(8) if i % 2]
    assert shed == [f"row{i}".encode() for i in range(8) if not i % 2]
    assert tags == [("overloaded", "deadline")] * 4
    assert offered == len(delivered) + len(shed) and deadline_sheds == 4


def test_stream_nacks_shed_batch_without_error_output():
    def go(pkg):
        log: list = []
        stream = pkg.Stream(pkg.MemoryInput([b"x"]), pkg.Pipeline([]), collect(pkg),
                            thread_num=1, name=uname("shed-nack"),
                            overload=pkg.overload.OverloadConfig(enabled=True))

        async def shed():
            item = pkg.stream_mod._WorkItem(pkg.batch.MessageBatch.new_binary([b"x"]),
                                            ack_log(pkg, log), 0.0)
            await stream._shed_item(item, "queue")
            item = pkg.stream_mod._WorkItem(pkg.batch.MessageBatch.new_binary([b"x"]),
                                            ack_log(pkg, log, redeliverable=False), 0.0)
            await stream._shed_item(item, "queue")

        run(shed())
        return log

    assert both(go) == ["nack", "ack"]


def test_expired_absolute_deadline_is_acked_not_nacked():
    def go(pkg):
        log: list = []
        stream = pkg.Stream(pkg.MemoryInput([b"x"]), pkg.Pipeline([]), collect(pkg),
                            thread_num=1, name=uname("shed-expired"),
                            overload=pkg.overload.OverloadConfig(enabled=True, deadline_ms=50.0))
        mb = pkg.batch.MessageBatch.new_binary

        async def shed():
            stale = mb([b"x"]).with_deadline_ms(time.time() * 1000.0 - 10_000)
            await stream._shed_item(pkg.stream_mod._WorkItem(stale, ack_log(pkg, log), 0.0),
                                    "deadline")
            fresh = mb([b"x"]).with_deadline_ms(time.time() * 1000.0 + 60_000)
            await stream._shed_item(pkg.stream_mod._WorkItem(fresh, ack_log(pkg, log), 0.0),
                                    "queue")

        run(shed())
        return log

    assert both(go) == ["ack", "nack"]


def test_stream_expires_stale_batch_at_dequeue():
    def go(pkg):
        shed = collect(pkg)
        stream = pkg.Stream(pkg.MemoryInput([]), pkg.Pipeline([]), collect(pkg),
                            error_output=shed, thread_num=1, name=uname("expire"),
                            overload=pkg.overload.OverloadConfig(enabled=True,
                                                                 deadline_ms=10_000.0))

        async def go_():
            stale = pkg.batch.MessageBatch.new_binary([b"x"]).with_deadline_ms(
                time.time() * 1000.0 - 1.0)
            inq, outq = asyncio.Queue(), asyncio.Queue()
            await inq.put(pkg.stream_mod._WorkItem(stale, pkg.NoopAck(),
                                                   asyncio.get_running_loop().time()))
            await inq.put(pkg.stream_mod._DONE)
            await stream._do_processor(inq, outq)
            return outq.qsize()

        left = run(go_())
        return ([b.get_meta("__meta_ext_shed_reason") for b in shed.batches],
                stream.overload.m_shed["deadline"].value, left, stream.overload.queued)

    assert both(go) == (["deadline"], 1.0, 1, 0)


def test_build_stream_wires_queue_size_and_controller():
    def go(pkg):
        out = []
        for pipeline in ({"thread_num": 2, "queue_size": 6, "deadline_ms": 100, "processors": []},
                         {"thread_num": 2, "processors": []}):
            cfg = pkg.config.StreamConfig.from_mapping({
                "input": {"type": "memory", "messages": ["a"]}, "pipeline": pipeline,
                "output": {"type": "drop"}})
            s = pkg.build_stream(cfg, name=uname("wire"))
            ov = s.overload
            out.append((s.queue_size, None if ov is None else
                        (ov.cfg.deadline_ms, ov.max_window, ov.cfg.max_window, ov.min_window)))
        return out

    assert both(go) == [(6, (100.0, 6, 0, 1)), (8, None)]


def test_reorder_window_fill_accumulates_backpressure_and_wait_metrics(monkeypatch):
    for pkg in PKGS:
        monkeypatch.setattr(pkg.stream_mod, "MAX_PENDING", 2)

    def go(pkg):
        class SlowOutput(pkg.DropOutput):
            def __init__(self):
                super().__init__()
                self.n = 0

            async def write(self, batch):
                await asyncio.sleep(0.004)
                self.n += batch.num_rows

        sink = SlowOutput()
        stream = pkg.Stream(pkg.MemoryInput([str(i).encode() for i in range(30)]),
                            pkg.Pipeline([]), sink, thread_num=4, name=uname("bp"))
        run(stream.run(asyncio.Event()))
        return (sink.n, stream.m_backpressure_s.value > 0, stream.m_queue_wait.count,
                stream.m_queue_wait.sum > 0)

    assert both(go) == (30, True, 30, True)


def test_pause_on_overload_pauses_the_source_and_counts_seconds():
    """A ``pause_on_overload`` source stops reading while the controller
    sheds with a full window: ``arkflow_overload_paused_seconds_total``
    grows and every offered batch is delivered or shed."""
    def go(pkg):
        cfg = pkg.config.StreamConfig.from_mapping({
            "input": {"type": "memory", "pause_on_overload": True,
                      "messages": [f"m{i}" for i in range(40)]},
            "pipeline": {"thread_num": 1, "queue_size": 4, "deadline_ms": 1000,
                         "overload": {"max_window": 2, "min_window": 1, "interval": "0s",
                                      "target_wait": "1ms"},
                         "processors": [{"type": "fault", "faults": [
                             {"kind": "latency", "every": 1, "times": 0, "duration": "5ms"}]}]},
            "output": {"type": "drop"}, "error_output": {"type": "drop"}})
        s = pkg.build_stream(cfg, name=uname("pause"))
        run(s.run(asyncio.Event()), timeout=30)
        shed = sum(c.value for c in s.overload.m_shed.values())
        return (s.m_batches_in.value == s.m_batches_out.value + shed,
                s._pause_source, s.overload.m_paused_s.value > 0)

    assert both(go) == (True, True, True)


def test_attach_and_pause_flags_walk_fault_wrapper_chains():
    def go(pkg):
        from_cfg = pkg.schedule.FaultSchedule(
            pkg.schedule.parse_faults([], pkg.wrappers.INPUT_KINDS, "input"), seed=1)
        ctrl = ctrl_of(pkg, {"max_window": 2})
        buf = pkg.MemoryBuffer(capacity=4, timeout_s=0.01, coalesce_buckets=[2])
        wrapped_buf = types.SimpleNamespace(_inner=buf)
        pkg.overload.attach_overload(wrapped_buf, ctrl)
        pkg.overload.attach_overload(wrapped_buf, None)
        return (buf._tenant_policy is ctrl.cfg.tenants,
                pkg.overload.input_pauses_on_overload(
                    pkg.wrappers.FaultInjectingInput(pkg.MemoryInput([b"a"]), from_cfg)),
                pkg.overload.input_pauses_on_overload(
                    pkg.wrappers.FaultInjectingInput(
                        pkg.MemoryInput([b"a"], pause_on_overload=True), from_cfg)))

    assert both(go) == (True, False, True)


def test_processing_error_with_shed_reason_takes_the_shed_path():
    """An error raised inside the chain with ``shed_reason`` (JAX's cluster
    retry budget) is routed as a shed and counted under that reason, never
    as a processing failure."""
    def go(pkg):
        class Shedding:
            async def connect(self):
                return None

            async def process(self, batch):
                e = RuntimeError("retry budget exhausted")
                e.shed_reason = "retry_budget"
                raise e

            async def close(self):
                return None

        shed = collect(pkg)
        s = pkg.Stream(pkg.MemoryInput([b"a", b"b"]), pkg.Pipeline([Shedding()]),
                       collect(pkg), error_output=shed, thread_num=1, name=uname("inchain"),
                       overload=pkg.overload.OverloadConfig(enabled=True))
        run(s.run(asyncio.Event()))
        return ([b.get_meta("__meta_ext_shed_reason") for b in shed.batches],
                s.overload.m_shed["retry_budget"].value, s.m_errors.value)

    assert both(go) == (["retry_budget"] * 2, 2.0, 0.0)


def test_burst_stream_identity_holds_with_the_example_knobs():
    """``overload_stream.json``'s stream at a few hundred rows on both
    packages: a 4x burst over a slow stage, the example's knobs. Sheds
    depend on timing, so only the identities are held: offered batches
    equal delivered plus shed, every shed batch lands tagged with a reason
    of ``SHED_REASONS``, and the shed counters equal the tagged counts."""
    import json
    from pathlib import Path

    raw = json.loads((Path(__file__).resolve().parent.parent / "arkflow_tpu_torch" /
                      "examples" / "overload_stream.json").read_text())
    stream_raw = raw["streams"][0]
    stream_raw["input"]["inner"].update(count=120, interval="1ms")
    stream_raw["pipeline"]["processors"][0]["faults"][0]["duration"] = "4ms"
    for pkg in PKGS:
        cfg = pkg.config.StreamConfig.from_mapping(stream_raw)
        s = pkg.build_stream(cfg, name=uname("burst"))
        sink, shed = collect(pkg), collect(pkg)
        s.output, s.error_output = sink, shed
        run(s.run(asyncio.Event()), timeout=60)
        reasons = [b.get_meta("__meta_ext_shed_reason") for b in shed.batches]
        assert all(b.get_meta("__meta_ext_error") == "overloaded" for b in shed.batches)
        assert set(reasons) <= set(pkg.overload.SHED_REASONS)
        assert s.m_batches_in.value == len(sink.batches) + len(shed.batches) == 240
        counted = {r: int(c.value) for r, c in s.overload.m_shed.items() if c.value}
        assert counted == {r: reasons.count(r) for r in set(reasons)}, pkg.name


def test_engine_health_reports_overload_controller_state():
    """``/health`` of the port's engine (port 0) carries the stream's
    ``overload`` report with JAX's keys, beside JAX's ``stream_health``."""
    import json

    from tests.test_torch_connectors import http_call

    stream = {"name": "ov-health", "input": {"type": "generate", "payload": "tick",
                                             "interval": "20ms", "batch_size": 1},
              "pipeline": {"thread_num": 1, "deadline_ms": 500, "processors": []},
              "output": {"type": "drop"}}

    async def go(pkg):
        hc = ({"enabled": True, "host": "127.0.0.1", "port": 0} if pkg is PORT
              else {"enabled": False})
        engine = pkg.engine_mod.Engine(pkg.config.EngineConfig.from_mapping(
            {"streams": [{**stream, "name": uname("ov-health")}], "health_check": hc}))
        task = asyncio.ensure_future(engine.run())
        try:
            for _ in range(100):
                await asyncio.sleep(0.05)
                if engine.streams:
                    break
            await asyncio.sleep(0.2)
            health = engine.stream_health()
            if pkg is PORT:
                status, _, body = await http_call(engine.health_port, "GET", "/health")
                assert status == 200
                over_http = json.loads(body)["stream_health"][engine.streams[0].name]
                assert set(over_http) == set(health[engine.streams[0].name])
            return health[engine.streams[0].name]
        finally:
            engine.shutdown()
            await asyncio.wait_for(task, 15)

    got = {pkg.name: run(go(pkg), timeout=30) for pkg in PKGS}
    for info in got.values():
        ov = info["overload"]
        assert ov["state"] in ("admit", "throttle", "shed") and ov["deadline_ms"] == 500.0
        assert set(ov["shed"]) == {"deadline", "queue", "priority", "quota", "retry_budget"}
        assert info["restarts"] == 0 and info["restart_budget_remaining"] is None
    assert set(got["port"]) == set(got["jax"])
    assert set(got["port"]["overload"]) == set(got["jax"]["overload"])
