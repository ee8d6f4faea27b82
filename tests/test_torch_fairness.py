"""Tenants, quotas, the fair queue's stream, the memory buffer's tenant lanes,
the inputs' tenant keys, the HTTP 429s and the response cache in front of
``gpu_inference``, against the JAX package's.

The scenarios of ``tests/test_fairness.py`` run once through each package
on the same batches and configs: tenant columns survive redelivery, splits
and quarantine; the controller's quota and share decisions; the buffer's
emissions per tenant; the stream's quota sheds with their tags and
counters; the HTTP input's statuses and ``Retry-After``. The cached
processor runs at ``TINY_BERT`` on the CPU, on JAX-initialised weights,
beside JAX's ``tpu_inference`` with the same cache, logits held to 1/64."""

import asyncio
import json
import math
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from tests.test_torch_connectors import _jax_port, http_call
from tests.test_torch_connectors import read_response
from tests.test_torch_overload import (JAX, PKGS, PORT, ack_log, both, clock, collect,  # noqa: F401
                                       ctrl_of, payloads_of, run, uname)
from tests.test_tpu_layer import TINY_BERT

ROOT = Path(__file__).resolve().parent.parent
LOGIT_ATOL = 1.0 / 64


def mb(pkg, payloads=(b"x",), tenant=None):
    b = pkg.batch.MessageBatch.new_binary(list(payloads))
    return b.with_tenant(tenant) if tenant is not None else b


def rows(batch) -> dict:
    return {k: v for k, v in batch.to_pydict().items()
            if k not in ("__meta_ingest_time", "__meta_ext_trace")}


# -- tenant metadata ------------------------------------------------------------------


def test_tenant_stamp_read_and_structural_survival():
    def go(pkg):
        b = mb(pkg, (b"a", b"b", b"c"), tenant="acme")
        merged = pkg.batch.MessageBatch.concat([b, mb(pkg, (b"d",), tenant="acme")])
        other = pkg.batch.MessageBatch.new_binary([b"a", b"b", b"c"]).with_tenant("other")
        return (b.tenant(), mb(pkg).tenant(), mb(pkg).tenant("dflt"), b.slice(1, 2).tenant(),
                [p.tenant() for p in b.split(1)], merged.tenant(), merged.num_rows,
                pkg.batch.batch_fingerprint(b) == pkg.batch.batch_fingerprint(other),
                rows(b.with_priority(3).with_deadline_ms(5e12)),
                b.with_priority(3).priority_band(), mb(pkg).priority_band(2),
                b.with_deadline_ms(5e12).deadline_unix_ms(),
                b.remaining_deadline_ms(250.0, now_ms=1000.0),
                b.with_ingest_time(900).remaining_deadline_ms(250.0, now_ms=1000.0),
                b.with_deadline_ms(2000).remaining_deadline_ms(250.0, now_ms=1000.0),
                pkg.batch.META_EXT_TENANT, pkg.batch.META_EXT_DEADLINE_MS,
                pkg.batch.META_EXT_PRIORITY)

    got = both(go)
    assert got[0] == "acme" and got[1] is None and got[2] == "dflt" and got[7]
    assert got[12:15] == (250.0, 150.0, 1000.0)


def test_tenant_survives_redelivery():
    async def go(pkg):
        sched = pkg.schedule.FaultSchedule(
            pkg.schedule.parse_faults([], pkg.wrappers.INPUT_KINDS, "input"))
        inp = pkg.wrappers.FaultInjectingInput(pkg.MemoryInput([b"m1"], tenant="acme"), sched,
                                               redeliver_unacked=True)
        await inp.connect()
        batch, ack = await inp.read()
        await ack.nack()
        batch2, ack2 = await inp.read()
        await ack2.ack()
        return batch.tenant(), batch2.tenant(), rows(batch2)

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"] and got["port"][:2] == ("acme", "acme")


def test_tenant_survives_split_ack_shares():
    def go(pkg):
        c = pkg.bucketing.MicroBatchCoalescer([2])
        c.add(mb(pkg, (b"r0", b"r1", b"r2"), tenant="acme"), pkg.NoopAck())
        head, _ = c.pop_exact()
        tail, _ = c.pop_flush()
        return rows(head), rows(tail)

    head, tail = both(go)
    assert head["__meta_ext_tenant"] == ["acme"] * 2 and tail["__meta_ext_tenant"] == ["acme"]


def test_tenant_survives_quarantine_path():
    def go(pkg):
        class Boom:
            async def connect(self):
                return None

            async def process(self, batch):
                raise RuntimeError("poison")

            async def close(self):
                return None

        err = collect(pkg)
        s = pkg.Stream(pkg.MemoryInput([b"bad row"], tenant="acme"), pkg.Pipeline([Boom()]),
                       collect(pkg), error_output=err, name=uname("q-tenant"))
        run(s.run(asyncio.Event()))
        return [(b.tenant(), b.get_meta("__meta_ext_error")) for b in err.batches]

    assert both(go) == [("acme", "poison")]


# -- the inputs' tenant keys ----------------------------------------------------------


def _read_all(pkg, cfg: dict) -> list:
    async def go():
        inp = (JAX.build_component if pkg is JAX else PORT.build_component)("input", cfg)
        await inp.connect()
        out = []
        try:
            while True:
                batch, _ = await inp.read()
                out.append(rows(batch))
        except pkg.EndOfInput:
            pass
        await inp.close()
        return out

    return run(go())


@pytest.fixture(autouse=True, scope="module")
def _builders():
    from arkflow_tpu.components import Resource as JR
    from arkflow_tpu.components import build_component as jb
    from arkflow_tpu_torch.components import Resource as PR
    from arkflow_tpu_torch.components import build_component as pb

    JAX.build_component = lambda fam, cfg: jb(fam, cfg, JR())
    PORT.build_component = lambda fam, cfg: pb(fam, cfg, PR())
    yield


@pytest.mark.parametrize("cfg", [
    {"type": "generate", "payload": "a b", "batch_size": 3, "count": 20, "tenants": 3},
    {"type": "generate", "payloads": ["x", "y z"], "batch_size": 2, "count": 7, "tenants": 2,
     "codec": "json"},
    {"type": "memory", "messages": ["a", "b"], "tenant": "team-a"},
    {"type": "memory", "messages": ["a"], "tenant": ""},
    {"type": "memory", "messages": ["a"], "pause_on_overload": True},
], ids=["generate_tenants", "generate_codec", "memory_tenant", "memory_empty", "memory_pause"])
def test_input_tenant_keys_stamp_as_jax(cfg):
    if cfg.get("codec") == "json":
        cfg = {**cfg, "payloads": ['{"t": "x"}', '{"t": "y z"}']}
    got = both(_read_all, cfg)
    assert got
    if cfg["type"] == "generate":
        assert [r["__meta_ext_tenant"][0] for r in got[:4]] == \
            [f"tenant{i % cfg['tenants']}" for i in range(4)]


def test_generate_and_memory_flags_match_jax():
    for cfg in ({"type": "memory", "messages": ["a"], "pause_on_overload": True},
                {"type": "memory", "messages": ["a"]}, {"type": "generate", "payload": "x"}):
        j, p = JAX.build_component("input", cfg), PORT.build_component("input", cfg)
        assert p.pause_on_overload == j.pause_on_overload
    with pytest.raises(PORT.ConfigError, match="generate.tenants must be non-negative"):
        PORT.build_component("input", {"type": "generate", "payload": "x", "tenants": -1})


async def _http_session(pkg, cfg: dict, calls: list, ctrl_cfg=None, drain=None):
    """The calls in turn against one package's http input (a controller of
    that package attached when ``ctrl_cfg`` is given, ``drain`` tenants'
    row buckets emptied first): per call (status, Retry-After, text), and
    the batches read after."""
    inp = pkg.build_component("input", cfg)
    await inp.connect()
    port = _jax_port(inp) if pkg is JAX else inp.port
    if ctrl_cfg is not None:
        ctrl = ctrl_of(pkg, ctrl_cfg)
        for t in drain or ():
            ts = ctrl.tenant_state(t)
            while ts.rows_bucket.try_acquire():
                pass
        pkg.overload.attach_overload(inp, ctrl)
    answers = []
    try:
        for body, headers in calls:
            status, hdrs, payload = await http_call(port, "POST", cfg.get("path", "/"), body,
                                                    headers)
            answers.append((status, hdrs.get("retry-after"), payload.decode()))
        batches = []
        while True:
            try:
                batch, _ = await asyncio.wait_for(inp.read(), 0.1)
            except asyncio.TimeoutError:
                break
            batches.append(rows(batch))
    finally:
        await inp.close()
    return answers, batches


BASIC = {"Authorization": "Basic YWNtZS11c2VyOnB3"}  # acme-user:pw


def test_http_tenant_header_auth_fallback_and_quota_429():
    """The configured header wins, the basic-auth username is the fallback;
    a tenant past its quota answers 429 with ``Retry-After`` = ceil of its
    bucket's ``time_until`` (at least 1), and another tenant is not
    implicated."""
    cfg = {"type": "http", "host": "127.0.0.1", "port": 0, "path": "/ingest",
           "tenant_header": "X-Tenant-Id",
           "auth": {"type": "basic", "username": "acme-user", "password": "pw"}}
    calls = [(b"h", {**BASIC, "X-Tenant-Id": "acme"}), (b"s", BASIC),
             (b"q", {**BASIC, "X-Tenant-Id": "noisy"}), (b"ok", {**BASIC, "X-Tenant-Id": "other"})]
    ctrl_cfg = {"tenants": {"per_tenant": {"noisy": {"rows_per_sec": 0.5}}}}
    got = {pkg.name: run(_http_session(pkg, cfg, calls, ctrl_cfg, drain=("noisy",)))
           for pkg in PKGS}
    assert got["port"] == got["jax"]
    answers, batches = got["port"]
    assert [a[0] for a in answers] == [200, 200, 429, 200]
    assert answers[2] == (429, "2", "tenant quota exceeded")  # ceil(1 row / 0.5 per s)
    assert [b["__meta_ext_tenant"] for b in batches] == [["acme"], ["acme-user"], ["other"]]


def test_http_overload_then_quota_then_rate_limit_429_order():
    """``_check_admission``'s order: the engine's overload first (the drain
    estimate, and no rate-limit token spent), then the tenant's quota
    (checked without spending), then the rate limiter."""
    cfg = {"type": "http", "host": "127.0.0.1", "port": 0, "path": "/",
           "rate_limit": {"capacity": 1, "per_second": 0.25}}

    async def go(pkg):
        inp = pkg.build_component("input", cfg)
        await inp.connect()
        port = _jax_port(inp) if pkg is JAX else inp.port
        ctrl = ctrl_of(pkg, {"max_window": 1, "tenants": {"per_tenant": {
            "t": {"rows_per_sec": 0.25}}}})
        ctrl.observe_step(2.0)
        ctrl.on_enqueue()
        ctrl.state = pkg.overload.STATE_SHED
        pkg.overload.attach_overload(inp, ctrl)
        out = []
        try:
            out.append(await http_call(port, "POST", "/", b"shed me"))
            ctrl.on_dequeue(0.0)
            ctrl.state = pkg.overload.STATE_ADMIT
            ts = ctrl.tenant_state("t")
            while ts.rows_bucket.try_acquire():
                pass
            out.append(await http_call(port, "POST", "/", b"q", {"X-Arkflow-Tenant": "t"}))
            out.append(await http_call(port, "POST", "/", b"ok"))
            out.append(await http_call(port, "POST", "/", b"again"))
        finally:
            await inp.close()
        return [(s, h.get("retry-after"), p.decode()) for s, h, p in out]

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"] == [(429, "2", "overloaded"), (429, "4", "tenant quota exceeded"),
                           (200, None, "ok"), (429, "4", "rate limited")]


@pytest.mark.parametrize("value", [7, "", False, None, "X-Team"], ids=str)
def test_http_tenant_header_config_matches_jax(value):
    cfg = {"type": "http", "port": 0, "tenant_header": value}

    def go(pkg):
        try:
            inp = pkg.build_component("input", cfg)
        except pkg.ConfigError as e:
            return ("error", str(e))
        inp.auth = types.SimpleNamespace(subject=lambda: "u")
        req = types.SimpleNamespace(headers={})
        return ("ok", inp.tenant_header, inp._tenant_of(req))

    got = both(go)
    if value is False:
        assert got == ("ok", None, None)  # the full opt-out: no auth fallback either


# -- the controller's quotas and shares --------------------------------------------


def test_quota_rows_shed_and_accounting(clock):
    def go(pkg):
        ctrl = ctrl_of(pkg, {"max_window": 8, "interval": "0s", "tenants": {
            "per_tenant": {"noisy": {"rows_per_sec": 2}}}})
        out = [ctrl.admit(0, None, tenant="noisy", rows=1.0) for _ in range(3)]
        out.append(ctrl.admit(0, None, tenant="calm", rows=1.0))
        rep = ctrl.report()
        return out, rep["shed"]["quota"], rep["tenants"]

    verdicts, quota, tenants = both(go)
    assert verdicts == [None, None, "quota", None] and quota == 1
    assert tenants["noisy"]["shed"] == {"quota": 1}


def test_quota_tokens_checked_before_rows_consumed(clock):
    def go(pkg):
        ctrl = ctrl_of(pkg, {"tenants": {"per_tenant": {
            "t": {"rows_per_sec": 100, "tokens_per_sec": 10}}}})
        ts = ctrl.tenant_state("t")
        out = [ctrl.admit(0, None, tenant="t", rows=1.0, tokens=50.0),
               ts.tokens_bucket._tokens, ts.rows_bucket._tokens,
               ctrl.admit(0, None, tenant="t", rows=1.0, tokens=5.0), ts.rows_bucket._tokens]
        return out

    got = both(go)
    assert got[0] is None and got[1] == -40.0 and got[3] == "quota" and got[4] == got[2]


def test_fair_share_lone_tenant_and_queue_shed_spend_no_quota(clock):
    def go(pkg):
        ctrl = ctrl_of(pkg, {"max_window": 8, "tenants": {"per_tenant": {
            "big": {"weight": 3}, "small": {"weight": 1, "rows_per_sec": 100}}}})
        out = []
        for t, n in (("small", 2), ("big", 6)):
            for _ in range(n):
                out.append(ctrl.admit(0, None, tenant=t))
                ctrl.on_enqueue(t)
        out += [ctrl._fair_share(ctrl.tenant_state("big")),
                ctrl._fair_share(ctrl.tenant_state("small")),
                ctrl.admit(0, None, tenant="small"), ctrl.tenant_state("small").rows_bucket._tokens]
        lone = ctrl_of(pkg, {"max_window": 4, "tenants": {}})
        for _ in range(4):
            out.append(lone.admit(0, None, tenant="only"))
            lone.on_enqueue("only")
        out.append(lone.admit(0, None, tenant="only"))
        return out

    got = both(go)
    assert got[8:11] == [6, 2, "queue"] and got[11] == 98.0 and got[-1] == "queue"


def test_oversized_batch_and_quota_retry_after(clock):
    def go(pkg):
        ctrl = ctrl_of(pkg, {"tenants": {"per_tenant": {"t": {"rows_per_sec": 4},
                                                        "tok": {"tokens_per_sec": 10}}}})
        out = [ctrl.admit(0, None, tenant="t", rows=500.0),
               ctrl.tenant_state("t").rows_bucket._tokens,
               ctrl.admit(0, None, tenant="t", rows=1.0),
               ctrl.quota_retry_after_s("t", rows=4.0), ctrl.quota_retry_after_s("tok"),
               ctrl.quota_retry_after_s("unmetered")]
        ctrl.tenant_state("tok").tokens_bucket.drain(50.0)
        out.append(ctrl.quota_retry_after_s("tok"))
        clock.t += 30.0
        out.append(ctrl.quota_retry_after_s("t", rows=4.0))
        return out

    got = both(go)
    assert got[0] is None and got[1] == -496.0 and got[2] == "quota"
    assert 0 < got[3] < math.inf and got[4] == got[5] == 0.0 and 0 < got[6] < math.inf


@pytest.mark.parametrize("column", ["binary", "string", "missing", "numeric"])
def test_token_estimates_match_jax(column):
    """Tokens/s metering reads the policy's ``token_field`` with its
    ``token_bytes``, a binary column or a string one (the port's
    ``StringColumn``), and meters a row a token without a usable column."""
    texts = ["hello, world", "a b c d e f", "x" * 40, "", "one-two three"]

    def go(pkg, token_bytes):
        data = {"binary": {"body": [t.encode() for t in texts]}, "string": {"body": texts},
                "missing": {"other": texts}, "numeric": {"body": list(range(5))}}[column]
        batch = pkg.batch.MessageBatch.from_pydict(data)
        policy = pkg.overload.TenantPolicy.from_config(
            {"token_field": "body", "token_bytes": token_bytes,
             "default_quota": {"tokens_per_sec": 1000}})
        return pkg.Stream._estimate_tokens(batch, policy)

    for token_bytes in (None, 4.0):
        got = both(go, token_bytes)
        if column in ("missing", "numeric"):
            assert got == 5.0


# -- the memory buffer's tenant lanes ------------------------------------------------


async def _drain(buf, acks=None) -> list:
    out = []
    while True:
        item = await buf.read()
        if item is None:
            return out
        out.append(rows(item[0]))
        await item[1].ack()


def test_buffer_plain_path_never_merges_tenants():
    async def go(pkg):
        buf = pkg.MemoryBuffer(capacity=4)
        for p, t in ((b"a0", "a"), (b"b0", "b"), (b"a1", "a"), (b"u0", None)):
            await buf.write(mb(pkg, (p,), tenant=t), pkg.NoopAck())
        await buf.close()
        return await _drain(buf)

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert [e["__value__"] for e in got["port"]] == [[b"a0", b"a1"], [b"b0"], [b"u0"]]


def test_buffer_coalesced_path_never_merges_tenants():
    async def go(pkg):
        buf = pkg.MemoryBuffer(capacity=64, timeout_s=0.05, coalesce_buckets=[2, 4])
        acked: list = []
        for i in range(3):
            for t in "ab":
                log: list = []
                acked.append((f"{t}{i}", log))
                await buf.write(mb(pkg, (f"{t}{i}".encode(),), tenant=t), ack_log(pkg, log))
        emissions = []
        for _ in range(2):
            batch, a = await asyncio.wait_for(buf.read(), 2.0)
            emissions.append(rows(batch))
            await a.ack()
        await buf.close()
        emissions += await _drain(buf)
        return emissions, sorted(tag for tag, log in acked if log == ["ack"])

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    emissions, acked = got["port"]
    assert all(len(set(e["__meta_ext_tenant"])) == 1 for e in emissions)
    assert acked == [f"{t}{i}" for t in "ab" for i in range(3)]


def test_buffer_parked_tenant_groups_stay_in_backpressure_bound():
    async def go(pkg):
        buf = pkg.MemoryBuffer(capacity=4)
        for t in "abcd":
            await buf.write(mb(pkg, (t.encode(),), tenant=t), pkg.NoopAck())
        first = await buf.read()
        held = [buf._held_rows]
        while buf._ready:
            await buf.read()
        held.append(buf._held_rows)
        await buf.close()
        return first[0].num_rows, held

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"] == (1, [3, 0])


def test_buffer_tenant_lane_count_is_bounded_without_schema_mix():
    async def go(pkg):
        cap = pkg.overload.MAX_TENANT_LABELS
        buf = pkg.MemoryBuffer(capacity=4096, timeout_s=0.05, coalesce_buckets=[2])
        await buf.write(mb(pkg, (b"untagged",)), pkg.NoopAck())
        for i in range(cap + 16):
            await buf.write(mb(pkg, (b"x",), tenant=f"t{i:04d}"), pkg.NoopAck())
        lanes = buf._tenant_coalescers
        shape = (len(lanes), "__other__" in lanes, lanes[None].rows, lanes["__other__"].rows)
        await buf.close()
        drained = await _drain(buf)
        return shape, sum(len(e["__value__"]) for e in drained), len(drained)

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"][0][:3] == (65, True, 1) and got["port"][1] == 64 + 17


def test_deadline_flush_services_all_lanes_in_one_pass():
    async def go(pkg):
        buf = pkg.MemoryBuffer(capacity=64, timeout_s=0.1, coalesce_buckets=[8])
        for t in "abcd":
            await buf.write(mb(pkg, (t.encode(),), tenant=t), pkg.NoopAck())
        t0 = time.monotonic()
        got = [(await asyncio.wait_for(buf.read(), 5.0))[0].tenant() for _ in range(4)]
        elapsed = time.monotonic() - t0
        await buf.close()
        return sorted(got), elapsed < 0.3

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"] == (["a", "b", "c", "d"], True)


def test_buffer_reserves_configured_tenants_past_the_cap():
    async def go(pkg):
        ctrl = ctrl_of(pkg, {"tenants": {"per_tenant": {"premium": {"weight": 8}}}})
        buf = pkg.MemoryBuffer(capacity=4096, timeout_s=0.05, coalesce_buckets=[2])
        pkg.overload.attach_overload(buf, ctrl)
        for i in range(pkg.overload.MAX_TENANT_LABELS + 8):
            await buf.write(mb(pkg, (b"x",), tenant=f"t{i:04d}"), pkg.NoopAck())
        await buf.write(mb(pkg, (b"vip",), tenant="premium"), pkg.NoopAck())
        lane = buf._tenant_coalescers.get("premium")
        await buf.close()
        return lane is not None and lane.rows == 1

    assert all(run(go(pkg)) for pkg in PKGS)


def test_buffer_tenant_lanes_follow_cap_bus_and_retarget():
    """Every lane obeys a device OOM cap, lanes made after the announcement
    too; a tuner's retarget moves every lane, and a lane made later starts
    on the retargeted grid."""
    async def go(pkg):
        bus = pkg.bucketing.bucket_cap_bus()
        buf = pkg.MemoryBuffer(capacity=64, timeout_s=0.05, coalesce_buckets=[2, 4])
        await buf.write(mb(pkg, (b"x",), tenant="early"), pkg.NoopAck())
        try:
            bus.announce(2)
            out = [buf._tenant_coalescers["early"].target]
            await buf.write(mb(pkg, (b"y",), tenant="late"), pkg.NoopAck())
            out.append(buf._tenant_coalescers["late"].target)
        finally:
            bus.reset()
        out.append(buf.retarget_shapes([4, 8], None, 0.02, expect=[2, 4]))
        await buf.write(mb(pkg, (b"z",), tenant="later"), pkg.NoopAck())
        out += [buf._tenant_coalescers[k].target for k in ("early", "later")]
        await buf.close()
        await _drain(buf)
        return out

    got = {pkg.name: run(go(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"] == [2, 2, True, 8, 8]


# -- the stream ------------------------------------------------------------------


def test_stream_tenant_quota_shed_routes_to_error_output_tagged():
    def go(pkg):
        cfg = pkg.overload.OverloadConfig(
            enabled=True, max_window=8, interval_s=0.0,
            tenants=pkg.overload.TenantPolicy.from_config(
                {"per_tenant": {"noisy": {"rows_per_sec": 2}}}))
        out, err = collect(pkg), collect(pkg)
        s = pkg.Stream(pkg.MemoryInput([b"r1", b"r2", b"r3", b"r4"], tenant="noisy"),
                       pkg.Pipeline([]), out, error_output=err, name=uname("quota-e2e"),
                       overload=cfg)
        run(s.run(asyncio.Event()))
        rep = s.overload.report()
        return (payloads_of(out), payloads_of(err),
                [(b.get_meta("__meta_ext_error"), b.get_meta("__meta_ext_shed_reason"),
                  b.tenant()) for b in err.batches],
                s.overload.m_shed["quota"].value, rep["tenants"],
                s.overload.tenant_state("noisy").m_e2e.count)

    delivered, shed, tags, quota, tenants, e2e = both(go)
    assert delivered == [b"r1", b"r2"] and shed == [b"r3", b"r4"]
    assert tags == [("overloaded", "quota", "noisy")] * 2 and quota == 2
    assert tenants["noisy"]["admitted"] == 2 and e2e == 2


def test_tenant_stream_through_the_fair_queue_matches_jax():
    """Three generate tenants through the coalescing buffer, the WDRR
    queue and a slow stage, under a quota on ``tenant1``: no emission mixes
    tenants, quota sheds hit ``tenant1`` only, and offered equals delivered
    plus shed per tenant, in both packages (the counts depend on timing, the
    identities do not)."""
    raw = {"input": {"type": "generate", "payload": "a b c", "batch_size": 2, "count": 96,
                     "tenants": 3},
           "buffer": {"type": "memory", "capacity": 32, "timeout": "5ms",
                      "coalesce": {"batch_buckets": [2, 4], "deadline": "5ms"}},
           "pipeline": {"thread_num": 2, "deadline_ms": 2000,
                        "overload": {"max_window": 64, "tenants": {"per_tenant": {
                            "tenant0": {"weight": 8}, "tenant1": {"rows_per_sec": 8}}}},
                        "processors": [{"type": "fault", "faults": [
                            {"kind": "latency", "every": 1, "times": 0, "duration": "1ms"}]}]},
           "output": {"type": "drop"}}
    for pkg in PKGS:
        s = pkg.build_stream(pkg.config.StreamConfig.from_mapping(raw), name=uname("fq"))
        sink, err = collect(pkg), collect(pkg)
        s.output, s.error_output = sink, err
        run(s.run(asyncio.Event()), timeout=60)
        for b in sink.batches + err.batches:
            assert len(set(b.to_pydict()["__meta_ext_tenant"])) == 1, pkg.name
        by = {}
        for name, batches in (("out", sink.batches), ("shed", err.batches)):
            for b in batches:
                by.setdefault(b.tenant(), {"out": 0, "shed": 0})[name] += b.num_rows
        assert all(v["out"] + v["shed"] == 32 for v in by.values()), (pkg.name, by)
        quota = {b.tenant() for b in err.batches
                 if b.get_meta("__meta_ext_shed_reason") == "quota"}
        assert quota == {"tenant1"} and s.overload.m_shed["quota"].value > 0, pkg.name
        assert isinstance(s._pause_source, bool)


def test_engine_health_walks_wrapped_processors_for_cache():
    def go(pkg):
        class Cache:
            def report(self):
                return {"entries": 1}

        proc = types.SimpleNamespace(_inner=types.SimpleNamespace(cache=Cache()))
        stream = types.SimpleNamespace(name="wrapped", overload=None,
                                       pipeline=types.SimpleNamespace(processors=[proc]))
        eng = pkg.engine_mod.Engine(pkg.config.EngineConfig.from_mapping(
            {"streams": [{"input": {"type": "memory", "messages": []},
                          "output": {"type": "drop"}}]}))
        eng.streams = [stream]
        return eng.stream_health()

    assert both(go)["wrapped"]["response_caches"] == [{"entries": 1}]


# -- the response cache in front of gpu_inference (TINY_BERT) --------------------------


def _proc_cfg(kind: str, **extra) -> dict:
    return {"type": kind, "model": "bert_classifier", "model_config": TINY_BERT,
            "max_seq": 32, "batch_buckets": [4, 8], "seq_buckets": [16, 32],
            "outputs": ["label", "logits"], "response_cache": {"capacity": 64}, **extra}


@pytest.fixture(scope="module")
def cached_pair():
    """JAX's ``tpu_inference`` and the port's ``gpu_inference``, each with a
    response cache, the port on the JAX processor's initial weights."""
    from arkflow_tpu_torch.convert import params_from_jax
    from arkflow_tpu_torch.tpu.runner import ModelRunner

    jproc = JAX.build_component("processor", _proc_cfg("tpu_inference"))
    pproc = PORT.build_component("processor", _proc_cfg("gpu_inference", device="cpu"))
    host = jax.device_get(jproc.runner.host_params)
    pproc.runner = ModelRunner("bert_classifier", TINY_BERT, buckets=pproc.runner.buckets,
                               device="cpu", host_params=params_from_jax(host))
    return jproc, pproc


TEXTS = [b"the quick brown fox", b"jumps over", b"the lazy dog again and again", b"hi"]


def test_sixteen_identical_batches_make_one_device_step(cached_pair):
    """16 concurrent identical batches through the cached processor: one
    device step, 16 bitwise-equal outputs, 15 collapsed, in both packages;
    the logits are JAX's within 1/64."""
    jproc, pproc = cached_pair

    async def go(pkg, proc):
        steps0 = proc.runner.device_steps if pkg is PORT else None
        batch = mb(pkg, TEXTS, tenant="acme")
        outs = await asyncio.gather(*[proc.process(batch) for _ in range(16)])
        cols = [o[0].to_pydict() for o in outs]
        same = all(c["label"] == cols[0]["label"] and
                   np.array_equal(np.asarray(c["logits"]), np.asarray(cols[0]["logits"]))
                   for c in cols)
        steps = None if steps0 is None else proc.runner.device_steps - steps0
        return same, cols[0], proc.cache.report(), steps

    jsame, jcol, jrep, _ = run(go(JAX, jproc), timeout=120)
    psame, pcol, prep, steps = run(go(PORT, pproc), timeout=120)
    assert jsame and psame and steps == 1
    assert {k: prep[k] for k in ("misses", "collapsed", "entries")} == \
        {k: jrep[k] for k in ("misses", "collapsed", "entries")} == \
        {"misses": 1, "collapsed": 15, "entries": 1}
    np.testing.assert_allclose(np.asarray(pcol["logits"]), np.asarray(jcol["logits"]),
                               atol=LOGIT_ATOL, rtol=0)


def test_cache_collapses_across_tenants_as_jax_does(cached_pair):
    """The fingerprint leaves the tenant column out: tenant B's batch of the
    same bytes gets tenant A's cached answer, counted as B's hit."""
    jproc, pproc = cached_pair

    async def go(pkg, proc):
        a = (await proc.process(mb(pkg, TEXTS[:2], tenant="team-a")))[0]
        b = (await proc.process(mb(pkg, TEXTS[:2], tenant="team-b")))[0]
        return (a.to_pydict()["label"] == b.to_pydict()["label"], b.tenant(),
                {t: int(c.value) for t, c in proc.cache._tenant_hits.items()})

    got = {"jax": run(go(JAX, jproc), timeout=120), "port": run(go(PORT, pproc), timeout=120)}
    assert got["port"][:2] == got["jax"][:2] == (True, "team-b")
    assert got["port"][2].get("team-b") == got["jax"][2].get("team-b") == 1


def test_cache_epoch_bumps_on_swap_commit(tmp_path):
    """A committed hot swap bumps the cache's epoch (the swapper's commit
    hook): a duplicate after it misses, recomputes on the new weights and
    answers otherwise; the tuner registers the same hook."""
    from arkflow_tpu_torch.models import get_model
    from arkflow_tpu_torch.tpu import checkpoint
    from arkflow_tpu_torch.tpu.runner import init_host_params

    fam = get_model("bert_classifier")
    ckpt = tmp_path / "seed1"
    checkpoint.save(str(ckpt), init_host_params(fam, fam.make_config(**TINY_BERT), 1))
    proc = PORT.build_component("processor", _proc_cfg(
        "gpu_inference", device="cpu", tuner={"interval": "1h"},
        swap={"canary": {"rows": 4, "min_agreement": 0.0}}))
    assert proc.cache.bump_epoch in proc.swapper._commit_hooks
    assert proc.cache.bump_epoch in proc.tuner._commit_hooks

    async def go():
        batch = mb(PORT, TEXTS)
        before = (await proc.process(batch))[0].to_pydict()["logits"]
        steps = proc.runner.device_steps
        await proc.process(batch)
        hit_steps = proc.runner.device_steps - steps
        await proc.swapper.swap(str(ckpt))
        after = (await proc.process(batch))[0].to_pydict()["logits"]
        return hit_steps, proc.cache.epoch, proc.cache.report()["misses"], \
            np.array_equal(np.asarray(before), np.asarray(after))

    hit_steps, epoch, misses, same = run(go(), timeout=120)
    assert hit_steps == 0 and epoch == 1 and misses == 2 and not same


def test_multitenant_example_at_tiny_width():
    """``multitenant_bert_stream.json`` as shipped (HTTP with
    ``tenant_header``, tenant lanes, quotas, the cache) on the CPU at
    ``TINY_BERT``: POSTs from three tenants over keep-alive connections;
    each batch carries its request's tenant, ``free`` past its 50 rows/s
    (burst 1 s) answers 429 with its bucket's ``Retry-After``, and every 200
    is delivered or in ``error_output``."""
    from arkflow_tpu_torch.config import EngineConfig
    from arkflow_tpu_torch.runtime.engine import Engine

    raw = json.loads((ROOT / "arkflow_tpu_torch/examples/multitenant_bert_stream.json")
                     .read_text())
    s = raw["streams"][0]
    s["name"] = uname("mt")
    s["input"]["port"] = 0
    s["pipeline"]["processors"][0].update(model_config=TINY_BERT, device="cpu",
                                          serving_dtype="float32")
    # a quota the CPU run surely outpaces (the card runs the example's 50 rows/s)
    s["pipeline"]["overload"]["tenants"]["per_tenant"]["free"]["rows_per_sec"] = 5
    raw["health_check"]["port"] = 0
    engine = Engine(EngineConfig.from_mapping(raw))
    stream = engine.build()[0]
    sink, err = collect(PORT), collect(PORT)
    stream.output, stream.error_output = sink, err

    async def client(port, tenant, n, until_429=0):
        """``n`` POSTs back to back; with ``until_429``, then one every 5 ms
        until one is answered 429 (the bucket is under one row only while
        admission has just spent it), at most ``until_429`` more."""
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        out = []
        i = 0
        while i < n or (i < n + until_429 and all(a[0] != 429 for a in out)):
            if i >= n:
                await asyncio.sleep(0.005)
            body = f"{tenant} text {i}".encode()
            i += 1
            writer.write((f"POST /infer HTTP/1.1\r\nHost: x\r\nConnection: keep-alive\r\n"
                          f"X-Tenant-Id: {tenant}\r\nContent-Length: {len(body)}\r\n\r\n")
                         .encode() + body)
            await writer.drain()
            status, hdrs, _ = await read_response(reader)
            out.append((status, hdrs.get("retry-after"), body))
        writer.close()
        return out

    async def go():
        task = asyncio.ensure_future(engine.run())
        for _ in range(400):
            await asyncio.sleep(0.05)
            if stream.input.port:
                break
        await asyncio.sleep(0.3)
        res = await asyncio.gather(client(stream.input.port, "premium", 30),
                                   client(stream.input.port, "free", 30, until_429=300),
                                   client(stream.input.port, "other", 10))
        await asyncio.sleep(1.0)
        engine.shutdown()
        await asyncio.wait_for(task, 60)
        return res

    premium, free, other = run(go(), timeout=180)
    assert {a[0] for a in premium + other} == {200}
    assert 429 in {a[0] for a in free} and {a[0] for a in free} <= {200, 429}
    for status, retry, _ in free:
        if status == 429:
            assert retry is not None and int(retry) >= 1
    ok = {body for status, _, body in premium + free + other if status == 200}
    seen = {}
    for b in sink.batches + err.batches:
        for value, tenant in zip(b.to_binary(), b.to_pydict()["__meta_ext_tenant"]):
            seen[value] = tenant
    assert ok <= set(seen)
    assert all(seen[v] == v.split()[0].decode() for v in ok)
