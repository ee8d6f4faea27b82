"""The port's metrics registry and tracer (``arkflow_tpu_torch/obs``) held to
the JAX package's (``arkflow_tpu/obs``) on the same sequences of calls: the
exposition text byte for byte, metric identity, the exposition parsed back,
thread safety, ``TraceContext``'s JSON across the packages, ``TracingConfig``
with JAX's messages and the ``ARKFLOW_TRACE=0`` switch, head sampling under a
seeded ``random``, forced commits, the store's bounds, ``stage_breakdown``,
the scope's nesting and a disabled tracer. Mirrors ``tests/test_obs_and_misc.py``
and ``tests/test_tracing.py``."""

import math
import random
import threading
import types

import pytest

from arkflow_tpu import obs as jax_obs
from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.obs import trace as jax_trace
from arkflow_tpu_torch import obs as port_obs
from arkflow_tpu_torch.batch import META_EXT_TRACE, MessageBatch, batch_fingerprint
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.obs import trace as port_trace
from tests.test_obs_and_misc import _parse_prometheus_text

JAX = types.SimpleNamespace(name="jax", obs=jax_obs, trace=jax_trace, ConfigError=JaxConfigError)
PORT = types.SimpleNamespace(name="port", obs=port_obs, trace=port_trace, ConfigError=ConfigError)
PKGS = (JAX, PORT)


# -- metrics ------------------------------------------------------------------


def _basic(reg) -> None:
    reg.counter("rows_total", "rows", {"stream": "s1"}).inc(5)
    reg.gauge("pending", "", {"stream": "s1"}).set(3)
    h = reg.histogram("lat_seconds", "latency", buckets=[0.1, 1.0])
    for v in (0.05, 0.5, 5.0):
        h.observe(v)


def _interleaved(reg) -> None:
    reg.counter("fam_a_total", "a", {"t": "x"}).inc(1)
    reg.gauge("fam_b", "b").set(2)
    reg.counter("fam_a_total", "a", {"t": "y"}).inc(3)
    h = reg.histogram("fam_h_seconds", "h", {"stream": "s"}, buckets=[0.1, 1.0])
    for v in (0.05, 0.5, 0.7, 5.0):
        h.observe(v)
    reg.counter("fam_evil_total", "e", {"tenant": 'a"b\\c\nd'}).inc(1)


def _defaults(reg) -> None:
    """The default latency buckets (``le`` as ``repr`` of each bound), a help
    text with a backslash and a newline, gauge inc/dec, label order."""
    h = reg.histogram("arkflow_e2e_seconds", "read-to-written\nlatency \\ per batch",
                      {"stream": "b", "a": "z"})
    for i in range(40):
        h.observe(0.00007 * 1.6 ** i)
    g = reg.gauge("arkflow_pending_batches", "in-flight batches", {"stream": "b"})
    g.inc(2.5)
    g.dec(0.25)
    reg.counter("arkflow_rows_in_total", "rows read from input", {"stream": "b"}).inc(1e-7)
    reg.counter("arkflow_rows_in_total", "rows read from input", {"stream": "a"}).inc(12345678)


def _fill(reg) -> None:
    """A histogram with explicit bounds at 0 and 1 (the fill and waste
    families), values on the bounds."""
    h = reg.histogram("arkflow_padding_waste_frac", "padding fraction", {"model": "m"},
                      buckets=[0.0, 0.125, 0.25, 0.5, 0.75, 0.9, 1.0])
    for v in (0.0, 0.125, 0.3, 1.0, 1.5):
        h.observe(v)


SEQUENCES = {"basic": _basic, "interleaved": _interleaved, "defaults": _defaults,
             "fill": _fill}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_exposition_equals_jax_byte_for_byte(seq):
    texts = {}
    for pkg in PKGS:
        reg = pkg.obs.MetricsRegistry()
        SEQUENCES[seq](reg)
        texts[pkg.name] = reg.exposition()
    assert texts["port"] == texts["jax"]


def test_exposition_lines_and_quantiles():
    reg = port_obs.MetricsRegistry()
    _basic(reg)
    text = reg.exposition()
    for line in ('# TYPE rows_total counter', 'rows_total{stream="s1"} 5.0',
                 'pending{stream="s1"} 3.0', 'lat_seconds_bucket{le="0.1"} 1',
                 'lat_seconds_bucket{le="1.0"} 2', 'lat_seconds_bucket{le="+Inf"} 3',
                 'lat_seconds_count 3'):
        assert line in text
    assert reg.histogram("lat_seconds").quantile(0.5) == 0.5
    assert math.isnan(reg.histogram("empty_seconds").quantile(0.5))


def test_reservoir_quantiles_equal_jax_past_its_size():
    """The reservoir replaces with the same seeded generator: past 2048
    samples the quantiles still equal JAX's."""
    rng = random.Random(3)
    values = [rng.expovariate(10.0) for _ in range(5000)]
    qs = {}
    for pkg in PKGS:
        h = pkg.obs.MetricsRegistry().histogram("q_seconds")
        for v in values:
            h.observe(v)
        qs[pkg.name] = [h.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
    assert qs["port"] == qs["jax"]


@pytest.mark.parametrize("kind", ["counter", "gauge", "histogram"])
def test_identity_is_name_plus_labels(kind):
    reg = port_obs.MetricsRegistry()
    make = getattr(reg, kind)
    a = make("x", labels={"s": "1", "t": "2"})
    assert make("x", labels={"t": "2", "s": "1"}) is a
    assert make("x", labels={"s": "2", "t": "2"}) is not a
    assert make("y", labels={"s": "1", "t": "2"}) is not a


def test_sum_values_and_global_registry():
    for pkg in PKGS:
        reg = pkg.obs.MetricsRegistry()
        reg.counter("misses", labels={"m": "a"}).inc(2)
        reg.counter("misses", labels={"m": "b"}).inc(3)
        reg.histogram("misses_seconds").observe(1.0)
        assert reg.sum_values("misses") == 5.0
    assert port_obs.global_registry() is port_obs.global_registry()
    assert port_obs.global_registry() is not jax_obs.global_registry()


def test_exposition_parses_back_and_histograms_conform():
    reg = port_obs.MetricsRegistry()
    _interleaved(reg)
    fams = _parse_prometheus_text(reg.exposition())
    assert fams["fam_a_total"]["type"] == "counter"
    assert len(fams["fam_a_total"]["samples"]) == 2
    assert fams["fam_h_seconds"]["type"] == "histogram"
    samples = fams["fam_h_seconds"]["samples"]
    buckets = [(lab["le"], v) for n, lab, v in samples if n.endswith("_bucket")]
    assert [v for _, v in buckets] == [1.0, 3.0, 4.0] and buckets[-1][0] == "+Inf"
    totals = {n: v for n, _, v in samples if not n.endswith("_bucket")}
    assert totals["fam_h_seconds_count"] == 4.0
    assert abs(totals["fam_h_seconds_sum"] - 6.25) < 1e-9
    (_, lab, _), = fams["fam_evil_total"]["samples"]
    assert lab["tenant"] == 'a"b\\c\nd'


def test_metrics_are_thread_safe_under_contention():
    reg = port_obs.MetricsRegistry()
    c = reg.counter("hammer_total")
    g = reg.gauge("hammer_gauge")
    h = reg.histogram("hammer_seconds", buckets=[0.5])
    n, t = 20_000, 8

    def work():
        for _ in range(n):
            c.inc()
            g.inc(2.0)
            h.observe(0.25)
            reg.counter("hammer_minted_total", labels={"k": "v"}).inc()

    threads = [threading.Thread(target=work) for _ in range(t)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert c.value == n * t and g.value == 2.0 * n * t
    assert h.count == n * t and h.counts[0] == n * t
    assert reg.counter("hammer_minted_total", labels={"k": "v"}).value == n * t


def test_timer_observes_the_block():
    h = port_obs.MetricsRegistry().histogram("t_seconds")
    with h.time():
        pass
    assert h.count == 1 and 0.0 <= h.sum < 1.0


# -- trace context and config ---------------------------------------------------


@pytest.mark.parametrize("ctx_args", [("abc123", "span9", False), ("feedbeef00000001", "", True)])
def test_trace_context_json_crosses_the_packages(ctx_args):
    port_ctx = port_trace.TraceContext(*ctx_args)
    jax_ctx = jax_trace.TraceContext(*ctx_args)
    assert port_ctx.to_json() == jax_ctx.to_json()
    assert port_ctx.to_dict() == jax_ctx.to_dict()
    assert jax_trace.TraceContext.from_json(port_ctx.to_json()) == jax_ctx
    assert port_trace.TraceContext.from_json(jax_ctx.to_json()) == port_ctx
    assert port_trace.TraceContext.from_json(port_ctx.to_dict()) == port_ctx
    assert port_ctx.with_parent("p2") == port_trace.TraceContext(ctx_args[0], "p2", ctx_args[2])


@pytest.mark.parametrize("bad", [None, "", "not json", "[]", '{"p":"x"}', b"\xff", 42])
def test_malformed_trace_context_is_untraced(bad):
    assert port_trace.TraceContext.from_json(bad) is None
    assert jax_trace.TraceContext.from_json(bad) is None


def test_tracing_config_parses_as_jax_s():
    for m in (None, {}, {"sample_rate": 0.5, "max_traces": 7}, {"enabled": False},
              {"sample_rate": 0, "max_open": 1, "max_spans_per_trace": 3, "slow_n": 2}):
        got = port_trace.TracingConfig.from_mapping(m)
        want = jax_trace.TracingConfig.from_mapping(m)
        assert vars(got) == vars(want)
    assert vars(port_trace.TracingConfig()) == vars(jax_trace.TracingConfig())


@pytest.mark.parametrize("bad", [{"sample_rate": 1.5}, {"sample_rate": -0.1},
                                 {"sample_rate": True}, {"sample_rate": "0.5"},
                                 {"max_traces": 0}, {"max_open": True},
                                 {"max_spans_per_trace": "x"}, {"slow_n": 1.5},
                                 {"enabled": "yes"}, 3, [1]])
def test_tracing_config_errors_carry_jax_s_messages(bad):
    with pytest.raises(ConfigError) as got:
        port_trace.TracingConfig.from_mapping(bad)
    with pytest.raises(JaxConfigError) as want:
        jax_trace.TracingConfig.from_mapping(bad)
    assert str(got.value) == str(want.value)


def test_env_kill_switch_survives_config_application(monkeypatch):
    monkeypatch.setenv("ARKFLOW_TRACE", "0")
    for pkg in PKGS:
        cfg = pkg.trace.TracingConfig
        assert cfg.from_mapping(None).enabled is False
        assert cfg.from_mapping({"sample_rate": 0.5}).enabled is False
        assert cfg.from_mapping({"enabled": True}).enabled is True
        assert pkg.trace._default_config().enabled is False
    monkeypatch.delenv("ARKFLOW_TRACE")
    assert port_trace.TracingConfig.from_mapping(None).enabled is True
    assert port_trace.FORCE_STATUSES == jax_trace.FORCE_STATUSES


# -- the tracer ----------------------------------------------------------------


def _ids(pkg, monkeypatch):
    """Deterministic span and trace ids, the same sequence in each package."""
    counter = iter(range(10 ** 6))
    monkeypatch.setattr(pkg.trace, "_new_id", lambda nbytes=8: f"{next(counter):016x}")


def _strip(recs: list) -> list:
    """Committed traces without their wall-clock fields."""
    out = []
    for r in recs:
        r = dict(r)
        r["spans"] = [{k: v for k, v in s.items() if k != "start_ms"} for s in r["spans"]]
        out.append(r)
    return out


def _head_sampling(pkg) -> dict:
    t = pkg.trace.Tracer(config=pkg.trace.TracingConfig(sample_rate=0.3))
    t._rng = random.Random(11)
    flags, committed = [], []
    for i in range(200):
        ctx = t.begin()
        flags.append(ctx.sampled)
        t.record(ctx, "stage_a", 0.001 * (i % 7))
        committed.append(t.finish(ctx, "ok", e2e_s=0.01))
    return {"flags": flags, "committed": committed, "summary": t.summary(),
            "breakdown": t.stage_breakdown()}


def _forced(pkg) -> dict:
    t = pkg.trace.Tracer(config=pkg.trace.TracingConfig(sample_rate=0.0))
    ctx = t.begin()
    t.record(ctx, "stage_a", 0.01)
    out = {"unsampled_ok": t.finish(ctx, "ok"), "forced": []}
    for status in (*pkg.trace.FORCE_STATUSES, "coalesced"):
        ctx = t.begin()
        t.record(ctx, "stage_a", 0.02)
        out["forced"].append(t.finish(ctx, status, attrs={"why": status}))
    out["recs"] = _strip(t.slowest(10))
    out["summary"] = t.summary()
    t2 = pkg.trace.Tracer(config=pkg.trace.TracingConfig(sample_rate=1.0))
    ctx = t2.begin()
    out["sampled_ok"] = (t2.finish(ctx, "ok", e2e_s=0.5), t2.slowest(1)[0]["e2e_ms"])
    return out


def _bounds(pkg) -> dict:
    t = pkg.trace.Tracer(config=pkg.trace.TracingConfig(max_traces=3, max_open=4,
                                                        max_spans_per_trace=2))
    for i in range(6):
        ctx = t.begin()
        for j in range(5):
            t.record(ctx, f"s{j}", 0.001 * (i + j))
        t.finish(ctx, "ok")
    for i in range(10):
        t.record(pkg.trace.TraceContext(f"open-{i}"), "s", 0.001)
    t.configure(pkg.trace.TracingConfig(max_traces=2))
    return {"recs": _strip(t.slowest(100)), "open_evicted": t.open_evicted,
            "spans_dropped": t.spans_dropped, "summary": t.summary()}


def _breakdown(pkg) -> dict:
    """Top-level and nested spans (explicit parents, fixed durations), a
    stage nested under two parents, min_seq views."""
    t = pkg.trace.Tracer(config=pkg.trace.TracingConfig())
    for i, dur in enumerate((0.010, 0.020, 0.030, 0.045)):
        ctx = t.begin()
        t.record(ctx, "queue_wait", 0.002 * i)
        pid = t.record(ctx, "process", dur)
        t.record(ctx, "infeed_prep", 0.001, parent_id=pid)
        t.record(ctx, "device_step", dur * 0.7, parent_id=pid, attrs={"bucket_rows": 8})
        other = t.record(ctx, "output_write", 0.003)
        if i % 2:
            t.record(ctx, "device_step", 0.0015, parent_id=other)
        t.finish(ctx, "ok", e2e_s=dur + 0.01 if i != 2 else None)
    seq = t.commit_seq()
    ctx = t.begin()
    t.record(ctx, "late", 0.001)
    t.finish(ctx, "ok")
    return {"all": t.stage_breakdown(), "delta": t.stage_breakdown(seq),
            "slowest2": _strip(t.slowest(2)), "seq": seq}


def _scope(pkg) -> dict:
    t = pkg.trace.Tracer(config=pkg.trace.TracingConfig())
    outside = pkg.trace.record_stage("orphan", 0.1)
    with pkg.trace.stage_span("orphan2"):
        pass
    ctx = t.begin()
    with pkg.trace.activate(t, ctx):
        with pkg.trace.stage_span("outer", attrs={"k": 1}):
            pkg.trace.record_stage("inner", 0.005)
            with pytest.raises(RuntimeError):
                with pkg.trace.stage_span("failing"):
                    raise RuntimeError("x")
        with pkg.trace.activate(t, ctx, parent_id="given"):
            pkg.trace.record_stage("reparented", 0.002)
    after = pkg.trace.current_scope()
    t.finish(ctx, "error")
    spans = {s["stage"]: s for s in t.slowest(1)[0]["spans"]}
    return {"outside": outside, "after": after, "stages": sorted(spans),
            "inner_under_outer": spans["inner"]["parent_id"] == spans["outer"]["span_id"],
            "failing_under_outer": spans["failing"]["parent_id"] == spans["outer"]["span_id"],
            "outer_root": spans["outer"]["parent_id"],
            "failing_attrs": spans["failing"]["attrs"], "outer_attrs": spans["outer"]["attrs"],
            "reparented": spans["reparented"]["parent_id"]}


def _disabled(pkg) -> dict:
    t = pkg.trace.Tracer(config=pkg.trace.TracingConfig(enabled=False))
    ctx = pkg.trace.TraceContext("t1")
    with pkg.trace.activate(t, ctx):
        scoped = pkg.trace.current_scope()
        recorded = pkg.trace.record_stage("s", 1.0)
    return {"begin": t.begin(), "record": t.record(ctx, "s", 1.0),
            "finish": t.finish(ctx, "error"), "slowest": t.slowest(5),
            "breakdown": t.stage_breakdown(), "scoped": scoped, "recorded": recorded,
            "adopt": t.adopt_spans(ctx, [{"stage": "x"}]), "summary": t.summary()}


SCENARIOS = {"head_sampling": _head_sampling, "forced": _forced, "bounds": _bounds,
             "breakdown": _breakdown, "scope": _scope, "disabled": _disabled}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tracer_equals_jax_on_the_same_calls(name, monkeypatch):
    got = {}
    for pkg in PKGS:
        _ids(pkg, monkeypatch)
        got[pkg.name] = SCENARIOS[name](pkg)
    assert got["port"] == got["jax"]


def test_head_sampling_and_forced_commit_properties(monkeypatch):
    _ids(PORT, monkeypatch)
    hs = _head_sampling(PORT)
    assert 30 < sum(hs["flags"]) < 90 and hs["committed"] == hs["flags"]
    forced = _forced(PORT)
    assert forced["unsampled_ok"] is False
    assert forced["forced"] == [True] * len(port_trace.FORCE_STATUSES) + [False]
    assert all(r["forced"] for r in forced["recs"])
    assert forced["summary"]["forced_samples"] == len(port_trace.FORCE_STATUSES)
    assert forced["sampled_ok"] == (True, 500.0)


def test_store_bounds_and_nested_breakdown_properties(monkeypatch):
    _ids(PORT, monkeypatch)
    b = _bounds(PORT)
    assert len(b["recs"]) == 2  # reconfigured ring keeps the newest
    assert all(len(r["spans"]) == 2 and r["dropped_spans"] == 3 for r in b["recs"])
    assert b["open_evicted"] > 0 and b["summary"]["traces_open"] <= 4
    bd = _breakdown(PORT)["all"]["stages"]
    assert bd["device_step"]["nested"] is True and bd["device_step"]["nested_under"] == "process"
    assert bd["device_step"]["share_of_e2e"] == 0.0
    assert sum(s["share_of_e2e"] for s in bd.values()) <= 1.0
    assert _breakdown(PORT)["delta"]["traces"] == 1


def test_adopt_and_export_cross_the_packages():
    """Spans exported by one package's tracer graft into the other's."""
    for src, dst in ((PORT, JAX), (JAX, PORT)):
        worker = src.trace.Tracer(tier="worker:w1", config=src.trace.TracingConfig())
        ingest = dst.trace.Tracer(tier="ingest", config=dst.trace.TracingConfig())
        ctx = ingest.begin()
        worker.record(src.trace.TraceContext(ctx.trace_id, "hopspan01"), "remote_step", 0.042)
        exported = worker.export_open(src.trace.TraceContext(ctx.trace_id, "hopspan01"))
        assert worker.summary()["traces_open"] == 0
        ingest.record(ctx, "cluster_hop", 0.050, span_id="hopspan01")
        ingest.adopt_spans(ctx, exported + [{"nope": 1}])
        ingest.finish(ctx, "ok")
        spans = {s["stage"]: s for s in ingest.slowest(1)[0]["spans"]}
        assert spans["remote_step"]["tier"] == "worker:w1"
        assert spans["remote_step"]["parent_id"] == "hopspan01"
        assert spans["remote_step"]["dur_ms"] == 42.0


def test_stage_spans_feed_the_stage_histogram():
    port_obs.global_registry().clear()
    t = port_trace.Tracer(config=port_trace.TracingConfig(sample_rate=0.0))
    ctx = t.begin()
    t.record(ctx, "queue_wait", 0.25)
    t.finish(ctx, "ok")  # unsampled: not committed, still observed
    h = port_obs.global_registry().histogram("arkflow_stage_seconds",
                                             labels={"stage": "queue_wait"})
    assert h.count == 1 and h.sum == 0.25
    assert t.slowest() == []


# -- the batch's trace column ---------------------------------------------------


def test_trace_column_survives_split_concat_and_quarantine_tagging():
    ctx = port_trace.TraceContext("feedbeef00000001")
    b = MessageBatch.new_binary([b"a", b"b", b"c", b"d"]).with_trace(ctx)
    assert b.trace_context() == ctx
    head, tail = b.slice(0, 2), b.slice(2)
    assert head.trace_context() == ctx and tail.trace_context() == ctx
    assert [p.trace_context() for p in b.split(3)] == [ctx, ctx]
    tagged = b.with_ext_metadata({"error": "boom", "delivery_attempts": "3"})
    assert tagged.trace_context() == ctx
    other = MessageBatch.new_binary([b"x"]).with_trace(port_trace.TraceContext("feedbeef00000002"))
    merged = MessageBatch.concat([tail, other, head])
    assert merged.source_trace_ids() == ["feedbeef00000001", "feedbeef00000002"]
    assert [c.trace_id for c in merged.source_trace_contexts()] == merged.source_trace_ids()
    assert batch_fingerprint(b) == batch_fingerprint(
        MessageBatch.new_binary([b"a", b"b", b"c", b"d"]))
    assert MessageBatch.new_binary([b"u"]).trace_context() is None
    assert MessageBatch.new_binary([b"u"]).source_trace_contexts() == []


def test_trace_column_equals_jax_s():
    ctx_args = ("feedbeef00000003", "p1", False)
    port_b = MessageBatch.new_binary([b"a", b"b"]).with_trace(port_trace.TraceContext(*ctx_args))
    jax_b = JaxBatch.new_binary([b"a", b"b"]).with_trace(jax_trace.TraceContext(*ctx_args))
    assert META_EXT_TRACE == "__meta_ext_trace"
    assert port_b.to_pydict()[META_EXT_TRACE] == jax_b.column(META_EXT_TRACE).to_pylist()
    assert port_b.schema[META_EXT_TRACE] == str(jax_b.schema.field(META_EXT_TRACE).type)
