"""The port's MQTT input, HTTP input, Redis and NATS outputs and their
utilities against the JAX package's, on the CPU.

MQTT QoS 1 and 2 delivery counts through the JAX package's fake with its
duplicate QoS 2 delivery; the HTTP input's status sequence and batches
against the JAX (aiohttp) input on the same requests (auth, the rate limit,
the queue bound, CORS, 413, a chunked body, the router's 404 and 405),
plus keep-alive on the stdlib server, the one tenant difference, and the
engine's health server on the shared reader; the bytes the Redis output
(cluster slot routing included) and the NATS output publish; ``auth``,
``rate_limiter`` and ``expr`` against JAX's; the keys the port refuses.
"""

from __future__ import annotations

import asyncio
import json
import time

import pytest

import arkflow_tpu.plugins.input.http as jax_http
import arkflow_tpu.utils.auth as jax_auth
import arkflow_tpu.utils.rate_limiter as jax_rl
from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, build_component, check_component
from arkflow_tpu_torch.components import ensure_plugins_loaded
from arkflow_tpu_torch.config import EngineConfig, StreamConfig
from arkflow_tpu_torch.connect.mqtt_client import MqttClient
from arkflow_tpu_torch.connect.nats_client import NatsClient
from arkflow_tpu_torch.connect.redis_client import RedisClient
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.plugins.input import http as port_http
from arkflow_tpu_torch.runtime.engine import Engine
from arkflow_tpu_torch.utils import auth as port_auth
from arkflow_tpu_torch.utils import rate_limiter as port_rl
from arkflow_tpu_torch.utils.expr import DynValue
from tests.test_connectors import FakeMqttBroker, FakeNatsServer, FakeRedisServer
from tests.test_redis_cluster import FakeCluster, _keys_for_both_nodes

jax_plugins()
ensure_plugins_loaded()


def run(coro, timeout: float = 20.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def stop(*fakes) -> None:
    """Stop JAX fakes' listeners without their ``stop``'s bounded wait."""
    for fake in fakes:
        for node in getattr(fake, "nodes", [fake]):
            node.server.close()


def both(family: str, cfg: dict):
    return jax_build(family, cfg, JaxResource()), build_component(family, cfg, Resource())


# -- MQTT ------------------------------------------------------------------------


@pytest.mark.parametrize("qos", [1, 2])
def test_mqtt_delivery_counts_match_jax(qos):
    """N messages published at ``qos`` to the JAX fake that sends every QoS 2
    delivery twice (the DUP retransmit): each input delivers each once."""
    async def go():
        broker = FakeMqttBroker(duplicate_qos2_delivery=True)
        await broker.start()
        try:
            cfg = {"type": "mqtt", "host": "127.0.0.1", "port": broker.port,
                   "topics": ["sensors/#"], "qos": qos, "codec": "json"}
            counts, batches = {}, {}
            for name, inp in zip(("jax", "port"), both("input", cfg)):
                await inp.connect()
                pub = MqttClient("127.0.0.1", broker.port, client_id=f"pub-{name}")
                await pub.connect()
                for i in range(12):
                    await pub.publish(f"sensors/s{i % 3}", json.dumps({"i": i}).encode(), qos=qos)
                got = []
                while True:
                    try:
                        got.append((await asyncio.wait_for(inp.read(), 0.3))[0])
                    except asyncio.TimeoutError:
                        break
                await pub.close()
                await inp.close()
                counts[name] = len(got)
                batches[name] = [{k: v for k, v in b.to_pydict().items()
                                  if k != "__meta_ingest_time"} for b in got]
            assert counts["port"] == counts["jax"] == 12
            assert batches["port"] == batches["jax"]
            assert batches["port"][4]["__meta_ext_topic"] == ["sensors/s1"]
        finally:
            stop(broker)

    run(go())


def test_mqtt_config_matches_jax(monkeypatch):
    monkeypatch.setenv("MQTT_TPW", "pw")
    cfg = {"type": "mqtt", "url": "tcp://h:1999", "topic": "t", "password": "${MQTT_TPW}",
           "username": "u"}
    j, p = both("input", cfg)
    assert (p.host, p.port, p.topics, p.username, p.password, p.client_id) == (
        j.host, j.port, j.topics, j.username, j.password, j.client_id)
    for bad in ({"type": "mqtt", "host": "h", "topics": ["t"], "qos": 3},
                {"type": "mqtt", "topics": ["t"]}, {"type": "mqtt", "host": "h"}):
        with pytest.raises(JaxConfigError) as je:
            jax_build("input", bad, JaxResource())
        with pytest.raises(ConfigError) as pe:
            check_component("input", bad)
        assert str(pe.value) == str(je.value)


# -- HTTP ------------------------------------------------------------------------


async def http_call(port: int, method: str, path: str, body: bytes = b"",
                    headers: dict | None = None, chunked: bool = False):
    """One request on a fresh connection: (status, headers, body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = [f"{method} {path} HTTP/1.1", "Host: x"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    if chunked:
        head.append("Transfer-Encoding: chunked")
        parts = [body[i:i + 7] for i in range(0, len(body), 7)]
        data = b"".join(b"%x\r\n%s\r\n" % (len(c), c) for c in parts) + b"0\r\n\r\n"
    else:
        head.append(f"Content-Length: {len(body)}")
        data = body
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
    await writer.drain()
    status, hdrs, payload = await read_response(reader)
    writer.close()
    return status, hdrs, payload


async def read_response(reader):
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    hdrs = {k.strip().lower(): v.strip() for k, _, v in
            (line.partition(":") for line in lines[1:] if line)}
    n = int(hdrs.get("content-length", "0"))
    return int(lines[0].split()[1]), hdrs, (await reader.readexactly(n) if n else b"")


def _jax_port(inp) -> int:
    return inp._runner.addresses[0][1]


async def _both_http(cfg: dict, calls: list):
    """The same requests, in turn, to the JAX input and to the port's:
    per package, the (status, Retry-After, CORS origin, text) of each call
    and the batches read afterwards."""
    out = {}
    for name, inp in zip(("jax", "port"), both("input", cfg)):
        await inp.connect()
        port = _jax_port(inp) if name == "jax" else inp.port
        answers = []
        for method, path, body, headers, chunked in calls:
            status, hdrs, payload = await http_call(port, method, path, body, headers, chunked)
            answers.append((status, hdrs.get("retry-after"),
                            hdrs.get("access-control-allow-origin"),
                            payload.decode() if status not in (404, 405, 413) else ""))
        batches = []
        while True:
            try:
                batch, _ = await asyncio.wait_for(inp.read(), 0.1)
            except asyncio.TimeoutError:
                break
            batches.append({k: v for k, v in batch.to_pydict().items()
                            if k != "__meta_ingest_time"})
        await inp.close()
        out[name] = (answers, batches)
    return out


def test_http_auth_rate_limit_and_cors_match_jax():
    token = {"Authorization": "Bearer sekret"}
    cfg = {"type": "http", "host": "127.0.0.1", "port": 0, "path": "/ingest",
           "auth": {"type": "bearer", "token": "sekret"}, "cors": True,
           "rate_limit": {"capacity": 3, "per_second": 0.01}}
    calls = [("OPTIONS", "/ingest", b"", {}, False),
             ("POST", "/ingest", b"{}", {}, False),
             ("POST", "/ingest", b"{}", {"Authorization": "Bearer wrong"}, False),
             *[("POST", "/ingest", b'{"a": %d}' % i, token, False) for i in range(3)],
             ("POST", "/ingest", b'{"a": 9}', token, False),
             ("GET", "/ingest", b"", token, False),
             ("POST", "/elsewhere", b"{}", token, False)]
    res = run(_both_http(cfg, calls))
    assert res["port"] == res["jax"]
    answers = res["port"][0]
    assert [a[0] for a in answers] == [204, 401, 401, 200, 200, 200, 429, 405, 404]
    assert answers[6][1] is not None and int(answers[6][1]) >= 1
    assert answers[3] == (200, None, "*", "ok")
    assert [b["__value__"] for b in res["port"][1]] == [[b'{"a": %d}' % i] for i in range(3)]


def test_http_queue_bound_413_and_chunked_match_jax(monkeypatch):
    monkeypatch.setattr(jax_http, "QUEUE_BOUND", 3)
    monkeypatch.setattr(port_http, "QUEUE_BOUND", 3)
    big = b"x" * ((1 << 20) + 10)
    cfg = {"type": "http", "host": "127.0.0.1", "port": 0, "path": "/p", "codec": "json"}
    calls = [("POST", "/p", b'{"id": 1, "t": "chunked body"}', {}, True),
             ("POST", "/p", b'{"id": 2}', {}, False),
             ("POST", "/p", big, {}, False),
             ("POST", "/p", b'{"id": 3}', {}, False),
             ("POST", "/p", b'{"id": 4}', {}, False),
             ("PUT", "/p", b"{}", {}, False)]
    res = run(_both_http(cfg, calls))
    assert res["port"] == res["jax"]
    assert [a[0] for a in res["port"][0]] == [200, 200, 413, 200, 503, 405]
    assert res["port"][0][4][3] == "queue full"
    assert [b["id"] for b in res["port"][1]] == [[1], [2], [3]]
    assert res["port"][1][0]["t"] == ["chunked body"]
    assert res["port"][1][0]["__meta_source"] == ["http"]


def test_http_basic_auth_lockout_matches_jax():
    cfg = {"type": "http", "host": "127.0.0.1", "port": 0, "path": "/",
           "auth": {"type": "basic", "username": "u", "password": "p"},
           "tenant_header": False}
    bad = {"Authorization": "Basic dTp4"}  # u:x
    good = {"Authorization": "Basic dTpw"}  # u:p
    calls = [("POST", "/", b"a", good, False)] + [("POST", "/", b"b", bad, False)] * 5
    calls += [("POST", "/", b"c", good, False)]  # locked out now
    res = run(_both_http(cfg, calls))
    assert res["port"] == res["jax"]
    assert [a[0] for a in res["port"][0]] == [200] + [401] * 6


def test_http_keep_alive_and_chunked_on_one_connection():
    async def go():
        inp = build_component("input", {"type": "http", "host": "127.0.0.1", "port": 0,
                                         "path": "/in"}, Resource())
        await inp.connect()
        reader, writer = await asyncio.open_connection("127.0.0.1", inp.port)
        try:
            statuses = []
            for i in range(4):
                body = b"payload-%d" % i
                if i == 2:
                    req = (b"POST /in HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                           b"4\r\npayl\r\n6;ext=1\r\noad-2!\r\n0\r\nTrailer: t\r\n\r\n")
                else:
                    req = (b"POST /in HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n"
                           % len(body)) + body
                writer.write(req)
                await writer.drain()
                status, hdrs, payload = await read_response(reader)
                statuses.append((status, hdrs["connection"], payload))
            # a 401/404 whose body the handler never read leaves the stream aligned
            writer.write(b"POST /other HTTP/1.1\r\nHost: x\r\nContent-Length: 3\r\n\r\nabc"
                         b"POST /in HTTP/1.0\r\nContent-Length: 2\r\n\r\nzz")
            await writer.drain()
            statuses.append((await read_response(reader))[0])
            status, hdrs, _ = await read_response(reader)
            statuses.append((status, hdrs["connection"]))
            assert await reader.read() == b""  # HTTP/1.0 without keep-alive: closed
            got = [(await inp.read())[0].to_binary()[0] for _ in range(5)]
        finally:
            writer.close()
            await inp.close()
        assert statuses == [(200, "keep-alive", b"ok")] * 4 + [404, (200, "close")]
        assert got == [b"payload-0", b"payload-1", b"payload-2!", b"payload-3", b"zz"]

    run(go())


def test_tenant_header_is_the_known_difference():
    """Once the one known difference, now none: both inputs stamp
    ``__meta_ext_tenant`` from ``X-Arkflow-Tenant`` (the default header)
    and leave a request without it untagged; the batches match."""
    cfg = {"type": "http", "host": "127.0.0.1", "port": 0, "path": "/"}
    calls = [("POST", "/", b"a", {"X-Arkflow-Tenant": "team-a"}, False),
             ("POST", "/", b"b", {}, False)]
    res = run(_both_http(cfg, calls))
    assert res["port"] == res["jax"]
    p1, p2 = res["port"][1]
    assert p1["__meta_ext_tenant"] == ["team-a"] and "__meta_ext_tenant" not in p2


@pytest.mark.parametrize("cfg,match", [
    ({"tenant_header": 7}, "tenant_header must be a header name or false"),
    ({"tenant_header": ""}, "tenant_header must be a header name or false"),
    ({"port": None}, "requires 'port'"),
    ({"auth": {"type": "digest"}}, "unknown auth type"),
    ({"rate_limit": {"capacity": 0}}, "positive capacity"),
])
def test_http_config_refusals(cfg, match):
    full = {"type": "http", "port": 8070, **cfg}
    with pytest.raises(ConfigError, match=match):
        check_component("input", full)
    with pytest.raises(ConfigError, match=match):
        build_component("input", full, Resource())


def test_http_quota_keys_refused_with_the_stream():
    """The per-tenant quotas of an HTTP stream live in ``pipeline.overload``:
    they parse to JAX's ``OverloadConfig``, and the http input's
    ``tenant_header`` builds as JAX's does."""
    from arkflow_tpu.config import StreamConfig as JaxStreamConfig

    raw = {"input": {"type": "http", "port": 0, "tenant_header": "X-Tenant-Id"},
           "pipeline": {"processors": [], "overload": {
               "tenants": {"per_tenant": {"team-a": {"rows_per_sec": 10}}}}},
           "output": {"type": "drop"}}
    port, jax_ = StreamConfig.from_mapping(raw), JaxStreamConfig.from_mapping(raw)
    assert repr(port.pipeline.overload) == repr(jax_.pipeline.overload)
    assert port.pipeline.overload.tenants.quota_of("team-a").rows_per_sec == 10.0
    j, p = both("input", raw["input"])
    assert p.tenant_header == j.tenant_header == "X-Tenant-Id"
    with pytest.raises(ConfigError, match="stream.overload is not yet ported"):
        StreamConfig.from_mapping({**raw, "overload": {}})


def test_health_server_keeps_alive_when_asked():
    async def go():
        engine = Engine(EngineConfig.from_mapping({
            "health_check": {"enabled": True, "host": "127.0.0.1", "port": 0},
            "streams": [{"input": {"type": "generate", "payload": "x", "count": 1},
                         "output": {"type": "drop"}}]}))
        await engine.start_health_server()
        reader, writer = await asyncio.open_connection("127.0.0.1", engine.health_port)
        try:
            answers = []
            for req in (b"GET /liveness HTTP/1.1\r\nConnection: keep-alive\r\n\r\n",
                        b"GET /readiness HTTP/1.1\r\nConnection: keep-alive\r\n\r\n",
                        b"POST /admin/swap HTTP/1.1\r\nConnection: keep-alive\r\n"
                        b"Content-Length: 5\r\n\r\n{nope",
                        b"GET /trace HTTP/1.1\r\n\r\n"):
                writer.write(req)
                await writer.drain()
                status, hdrs, payload = await read_response(reader)
                answers.append((status, hdrs["connection"], json.loads(payload)))
            assert await reader.read() == b""
        finally:
            writer.close()
            await engine.stop_health_server()
        assert [a[:2] for a in answers] == [(200, "keep-alive"), (503, "keep-alive"),
                                            (400, "keep-alive"), (200, "close")]
        assert set(answers[3][2]) == {"summary", "stage_breakdown", "slowest"}
        assert answers[0][2] == {"status": "alive"}

    run(go())


# -- Redis and NATS outputs --------------------------------------------------------


def _payload_batches(cls, n: int = 3):
    return [cls.new_binary([b"row-%d-%d" % (i, j) for j in range(i + 1)]).with_source("t")
            for i in range(n)]


async def _write_all(out, batches) -> None:
    await out.connect()
    for b in batches:
        await out.write(b)
    await out.close()


@pytest.mark.parametrize("mode", ["rpush", "lpush", "publish"])
def test_redis_output_matches_jax(mode):
    async def go():
        srv = FakeRedisServer()
        await srv.start()
        try:
            url = f"redis://127.0.0.1:{srv.port}"
            seen: dict = {"jl": [], "pl": []}
            sub = RedisClient(url)
            await sub.connect()
            task = asyncio.create_task(sub.subscribe_loop(
                ["jl", "pl"], [], lambda ch, p: seen[ch.decode()].append(p)))
            await asyncio.sleep(0.05)
            for target, cls, builder in (("jl", JaxBatch, jax_build), ("pl", MessageBatch, None)):
                cfg = {"type": "redis", "url": url, "mode": mode, "target": {"value": target}}
                out = (builder("output", cfg, JaxResource()) if builder
                       else build_component("output", cfg, Resource()))
                await _write_all(out, _payload_batches(cls))
            await asyncio.sleep(0.05)
            task.cancel()
            await sub.close()
            if mode == "publish":
                assert seen["pl"] == seen["jl"] and len(seen["pl"]) == 6
            else:
                assert srv.lists[b"pl"] == srv.lists[b"jl"] and len(srv.lists[b"pl"]) == 6
        finally:
            stop(srv)

    run(go())


def test_redis_cluster_output_routes_like_jax():
    async def go():
        clusters = [FakeCluster(), FakeCluster()]
        for c in clusters:
            await c.start()
        try:
            low, high = _keys_for_both_nodes()
            for cluster, cls, builder in ((clusters[0], JaxBatch, jax_build),
                                          (clusters[1], MessageBatch, None)):
                for key in (low, high):
                    cfg = {"type": "redis", "cluster": True, "urls": cluster.urls()[:1],
                           "mode": "rpush", "key": key}
                    out = (builder("output", cfg, JaxResource()) if builder
                           else build_component("output", cfg, Resource()))
                    await _write_all(out, _payload_batches(cls, 2))
            got = [n.lists for n in clusters[1].nodes]
            assert got == [n.lists for n in clusters[0].nodes]
            assert list(got[0]) == [low.encode()] and list(got[1]) == [high.encode()]
        finally:
            stop(*clusters)

    run(go())


def test_nats_output_matches_jax():
    async def go():
        srv = FakeNatsServer()
        await srv.start()
        try:
            url = f"nats://127.0.0.1:{srv.port}"
            seen: dict = {"sj": [], "sp": []}
            sub = NatsClient(url)
            await sub.connect()
            for s in seen:
                await sub.subscribe(s, lambda m: seen[m.subject].append(m.payload))
            for subject, cls, builder in (("sj", JaxBatch, jax_build), ("sp", MessageBatch, None)):
                out = (builder("output", {"type": "nats", "url": url, "subject": subject},
                               JaxResource()) if builder
                       else build_component("output", {"type": "nats", "url": url,
                                                       "subject": subject}, Resource()))
                await _write_all(out, _payload_batches(cls))
                batch = cls.from_pydict({"summary": ["a b", "c"]}).with_source("t")
                out = (builder("output", {"type": "nats", "url": url, "subject": subject},
                               JaxResource()) if builder
                       else build_component("output", {"type": "nats", "url": url,
                                                       "subject": subject}, Resource()))
                await _write_all(out, [batch])
            await asyncio.sleep(0.1)
            await sub.close()
            assert seen["sp"] == seen["sj"] and len(seen["sp"]) == 8
        finally:
            stop(srv)

    run(go())


@pytest.mark.parametrize("family,cfg", [
    ("output", {"type": "redis", "target": {"expr": "concat('k', id)"}}),
    ("output", {"type": "nats", "subject": {"expr": "concat('out.', city)"}}),
    ("output", {"type": "kafka", "brokers": "b:1", "topic": "t", "key": {"expr": "id"}}),
], ids=["redis_target", "nats_subject", "kafka_key"])
def test_expr_values_raise_not_ported(family, cfg):
    """The ``{expr: ...}`` values, once refused as not ported, now validate
    and build, and evaluate on a batch as JAX's ``DynValue`` does (per row
    for the NATS subject and the Kafka key, the first row for Redis)."""
    from arkflow_tpu.utils.expr import DynValue as JaxDyn

    check_component(family, cfg)
    out = build_component(family, cfg, Resource())
    field = next(k for k, v in cfg.items() if isinstance(v, dict))
    dyn = getattr(out, field)
    data = {"id": [1, 2], "city": ["sf", "la"]}
    jdyn = JaxDyn.from_config(cfg[field], field)
    assert dyn.is_expr
    assert (dyn.eval_per_row(MessageBatch.from_pydict(data))
            == jdyn.eval_per_row(JaxBatch.from_pydict(data)))
    assert (dyn.eval_scalar(MessageBatch.from_pydict(data))
            == jdyn.eval_scalar(JaxBatch.from_pydict(data)))


def test_output_config_errors_match_jax():
    for cfg in ({"type": "redis", "mode": "xadd", "target": "t"},
                {"type": "redis", "target": {"nope": 1}},
                {"type": "redis"},
                {"type": "nats"},
                {"type": "nats", "subject": "s", "password": "p"}):
        with pytest.raises(JaxConfigError) as je:
            jax_build("output", cfg, JaxResource())
        with pytest.raises(ConfigError) as pe:
            check_component("output", cfg)
        assert str(pe.value) == str(je.value)


# -- utilities -------------------------------------------------------------------


def test_dyn_value_literals_match_jax():
    from arkflow_tpu.utils.expr import DynValue as JaxDyn

    batch, jbatch = MessageBatch.new_binary([b"a", b"b"]), JaxBatch.new_binary([b"a", b"b"])
    for v in ("t", 5, {"value": "lit"}, {"value": None}):
        p, j = DynValue.from_config(v, "f"), JaxDyn.from_config(v, "f")
        assert p.eval_scalar(batch) == j.eval_scalar(jbatch)
    for bad in ({"expr": 3}, {"other": 1}):
        with pytest.raises(JaxConfigError) as je:
            JaxDyn.from_config(bad, "f")
        with pytest.raises(ConfigError) as pe:
            DynValue.from_config(bad, "f")
        assert str(pe.value) == str(je.value)


def test_auth_matches_jax(monkeypatch):
    monkeypatch.setenv("ARK_TEST_TOKEN", "tok")
    for m in (None, {}, {"type": "none"}, {"type": "bearer", "token": "${ARK_TEST_TOKEN}"},
              {"type": "basic", "username": "u", "password": "p"}):
        assert vars(port_auth.AuthConfig.from_config(m)) == vars(
            jax_auth.AuthConfig.from_config(m))
    for m in ({"type": "basic", "username": "u"}, {"type": "bearer"}, {"type": "x"},
              {"type": "bearer", "token": "${ARK_TEST_UNSET}"}):
        with pytest.raises(JaxConfigError) as je:
            jax_auth.AuthConfig.from_config(m)
        with pytest.raises(ConfigError) as pe:
            port_auth.AuthConfig.from_config(m)
        assert str(pe.value) == str(je.value)
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    cfg = {"type": "basic", "username": "u", "password": "p"}
    auths = [mod.Authenticator(mod.AuthConfig.from_config(cfg)) for mod in (jax_auth, port_auth)]
    headers = ["Basic dTpw", "Basic dTp4", None, "Bearer x", "Basic !!", "Basic dTp4",
               "Basic dTp4", "Basic dTp4", "Basic dTpw", "Basic dTpw"]
    outcomes = [[], []]
    for step, h in enumerate(headers * 2):
        clock[0] += 30.0 if step != 10 else 400.0  # the lockout served at step 10
        for a, out in zip(auths, outcomes):
            out.append((a.check(h, "c1"), a.check(h, "c2" if step % 2 else "c1")))
    assert outcomes[1] == outcomes[0]
    assert auths[1].subject() == auths[0].subject() == "u"


def test_token_bucket_matches_jax(monkeypatch):
    clock = [50.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    buckets = [mod.TokenBucket(3, 2.0) for mod in (jax_rl, port_rl)]
    trace = [[], []]
    for step in range(40):
        clock[0] += (step % 7) * 0.13
        for b, out in zip(buckets, trace):
            n = 1 + step % 3
            out.append((b.try_acquire(n), b.time_until(n), b.time_until(5)))
            if step % 11 == 0:
                b.drain(2)
    assert trace[1] == trace[0]
    with pytest.raises(ConfigError):
        port_rl.TokenBucket(0, 1.0)
