"""The other directions of the ported brokers and the small connectors,
against the JAX package's, on the CPU.

Each test builds the same config in both packages and feeds both the same
traffic through the JAX tests' own fakes (``tests/test_connectors.py``
NATS, Redis, MQTT and Modbus, ``tests/test_jetstream.py``'s JetStream,
``websockets.serve`` and an ``aiohttp.web`` sink): the ``nats`` input core
and JetStream (acks, the redelivery of an unacked batch), the ``redis``
input in list and subscribe mode (cluster slots checked), the ``mqtt``,
``http`` and ``influxdb`` outputs (the bytes published, the statuses, the
retries and JAX's error messages; ``encode_lines`` on hypothesis-made
batches), the ``websocket``, ``modbus`` and ``multiple_inputs`` inputs,
``Resource.input_names``, every input's ``pause_on_overload``, and the JAX
examples' and tests' configs built or refused alike. Then the four new
examples run at a tiny width on ``device: cpu`` over the port's fakes.
"""

from __future__ import annotations

import asyncio
import json
import math
from pathlib import Path

import numpy as np
import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.errors import Disconnection as JaxDisconnection
from arkflow_tpu.errors import EndOfInput as JaxEndOfInput
from arkflow_tpu.errors import WriteError as JaxWriteError
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, build_component, check_component
from arkflow_tpu_torch.components import ensure_plugins_loaded
from arkflow_tpu_torch.connect.mqtt_client import MqttClient
from arkflow_tpu_torch.connect.nats_client import NatsClient
from arkflow_tpu_torch.connect.redis_client import RedisClient
from arkflow_tpu_torch.errors import ConfigError, Disconnection, EndOfInput, WriteError
from arkflow_tpu_torch.plugins.output import influxdb as port_influx
from arkflow_tpu_torch.runtime import cli
from arkflow_tpu_torch.tools import broker_streams as bs
from arkflow_tpu_torch.tools import fake_brokers as pf
from tests.test_connectors import (FakeModbusServer, FakeMqttBroker, FakeNatsServer,
                                   FakeRedisServer)
from tests.test_jetstream import FakeJetStreamServer
from tests.test_redis_cluster import FakeCluster, _keys_for_both_nodes

jax_plugins()
ensure_plugins_loaded()

ROOT = Path(__file__).resolve().parent.parent


def run(coro, timeout: float = 20.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def stop(*fakes) -> None:
    """Stop JAX fakes' listeners without their ``stop``'s bounded wait."""
    for fake in fakes:
        for node in getattr(fake, "nodes", [fake]):
            (getattr(node, "server", None) or node._server).close()


def both(family: str, cfg: dict):
    return jax_build(family, cfg, JaxResource()), build_component(family, cfg, Resource())


def rows_of(batch) -> dict:
    return {k: v for k, v in batch.to_pydict().items() if k != "__meta_ingest_time"}


def refusals_match(family: str, cfg: dict) -> str:
    """Both packages refuse ``cfg`` with the same message; the message."""
    with pytest.raises(JaxConfigError) as je:
        jax_build(family, cfg, JaxResource())
    with pytest.raises(ConfigError) as pe:
        check_component(family, cfg)
    with pytest.raises(ConfigError) as be:
        build_component(family, cfg, Resource())
    assert str(pe.value) == str(be.value) == str(je.value)
    return str(pe.value)


async def read_all(inp, timeout: float = 0.3) -> list:
    out = []
    while True:
        try:
            out.append((await asyncio.wait_for(inp.read(), timeout))[0])
        except asyncio.TimeoutError:
            return out


# -- NATS input --------------------------------------------------------------------


def test_nats_core_input_matches_jax():
    """Both inputs subscribed to one subject of the JAX fake: every publish
    reaches each as the same batch, ``__meta_ext_subject`` included."""
    async def go():
        srv = FakeNatsServer()
        await srv.start()
        try:
            url = f"nats://127.0.0.1:{srv.port}"
            cfg = {"type": "nats", "url": url, "subject": "events", "codec": "json",
                   "queue_group": "workers"}
            inputs = both("input", cfg)
            for inp in inputs:
                await inp.connect()
            pub = NatsClient(url)
            await pub.connect()
            for i in range(6):
                await pub.publish("events", json.dumps({"i": i, "s": "x" * i}).encode())
            got = [[rows_of(b) for b in await read_all(inp)] for inp in inputs]
            await pub.close()
            for inp in inputs:
                await inp.close()
            assert got[1] == got[0] and len(got[1]) == 6
            assert got[1][3] == {"i": [3], "s": ["xxx"], "__meta_source": ["nats"],
                                 "__meta_ext_subject": ["events"]}
            for inp in inputs:
                with pytest.raises((EndOfInput, JaxEndOfInput)):
                    await inp.read()
        finally:
            stop(srv)

    run(go())


def test_jetstream_input_matches_jax_with_redelivery():
    """The JAX JetStream fake redelivers what is not acked: a batch that is
    nacked (a no-op, as in JAX) comes back on the next fetch with the rest;
    the acks reach the same stream sequences; the batches are equal."""
    async def one(kind: str):
        srv = FakeJetStreamServer()
        await srv.start()
        try:
            srv.messages += [json.dumps({"v": i}).encode() for i in range(5)]
            cfg = {"type": "nats", "url": f"nats://127.0.0.1:{srv.port}", "mode": "jetstream",
                   "stream": "EVENTS", "durable": "arkflow", "batch_size": 3, "codec": "json"}
            inp = (jax_build("input", cfg, JaxResource()) if kind == "jax"
                   else build_component("input", cfg, Resource()))
            await inp.connect()
            trace = []
            b1, a1 = await inp.read()
            trace.append((rows_of(b1), getattr(a1, "redeliverable", False)))
            await a1.nack()
            b2, a2 = await inp.read()  # b1's three again, as the fake redelivers
            trace.append((rows_of(b2), sorted(srv.acked)))
            await a2.ack()
            await asyncio.sleep(0.05)
            b3, a3 = await inp.read()
            await a3.ack()
            await asyncio.sleep(0.05)
            trace.append((rows_of(b3), sorted(srv.acked), dict(srv.delivered),
                          srv.consumers["arkflow"]["ack_policy"]))
            await inp.close()
            return trace
        finally:
            stop(srv)

    jax_trace, port_trace = run(one("jax")), run(one("port"))
    assert port_trace == jax_trace
    assert port_trace[0][0]["v"] == [0, 1, 2] and port_trace[0][1] is False
    assert port_trace[1][0]["v"] == [0, 1, 2]
    assert port_trace[0][0]["__meta_ext_stream"] == ["EVENTS"] * 3
    assert port_trace[2][0]["v"] == [3, 4] and port_trace[2][1] == [1, 2, 3, 4, 5]
    assert port_trace[2][2] == {1: 2, 2: 2, 3: 2, 4: 1, 5: 1}


@pytest.mark.parametrize("cfg", [
    {"type": "nats", "subject": "x", "jetstream": True},
    {"type": "nats", "mode": "jetstream", "stream": "S"},
    {"type": "nats", "mode": "jetstream", "stream": "S", "durable": "d",
     "deliver_policy": "bogus"},
    {"type": "nats"},
    {"type": "nats", "subject": "s", "password": "p"},
], ids=["js_gated", "no_durable", "policy", "no_subject", "password_alone"])
def test_nats_input_refusals_match_jax(cfg):
    refusals_match("input", cfg)


def test_nats_input_config_matches_jax():
    for cfg in ({"type": "nats", "url": "nats://h:1", "subject": "a.>", "queue_group": "q",
                 "username": "u", "password": "p"},
                {"type": "nats", "jetstream": True, "stream": "S", "durable": "d",
                 "subject": "s.x", "deliver_policy": "new", "batch_size": 7, "token": "t"}):
        j, p = both("input", cfg)
        assert type(p).__name__ == type(j).__name__
        keys = ("url", "subject", "queue_group", "stream", "durable", "batch_size",
                "deliver_policy", "filter_subject", "client_kwargs")
        assert ({k: getattr(p, k, None) for k in keys}
                == {k: getattr(j, k, None) for k in keys})
    with pytest.raises(ConfigError, match="'mystery' is not yet ported"):
        check_component("input", {"type": "nats", "subject": "s", "mystery": 1})


# -- Redis input ---------------------------------------------------------------------


def test_redis_list_input_matches_jax():
    """BLPOP over two keys of the JAX fake: the same batches, ``__meta_key``
    included, key by key in the order given."""
    async def go():
        srv = FakeRedisServer()
        await srv.start()
        try:
            url = f"redis://127.0.0.1:{srv.port}"
            out = {}
            for kind in ("jax", "port"):
                srv.lists[b"q.low"] = [b'{"n": %d}' % i for i in range(2)]
                srv.lists[b"q.high"] = [b'{"n": %d}' % i for i in range(2, 5)]
                cfg = {"type": "redis", "url": url, "mode": "list", "keys": ["q.high", "q.low"],
                       "codec": "json"}
                inp = (jax_build("input", cfg, JaxResource()) if kind == "jax"
                       else build_component("input", cfg, Resource()))
                await inp.connect()
                out[kind] = [rows_of((await asyncio.wait_for(inp.read(), 3))[0])
                             for _ in range(5)]
                await inp.close()
            assert out["port"] == out["jax"]
            assert [r["n"][0] for r in out["port"]] == [2, 3, 4, 0, 1]
            assert out["port"][0]["__meta_key"] == [b"q.high"]
        finally:
            stop(srv)

    run(go())


def test_redis_subscribe_input_matches_jax():
    """Channels on the JAX fake, then channels and patterns on the port's
    fake (the JAX fake has no PSUBSCRIBE): the same batches, the channel
    in ``__meta_ext_channel``."""
    async def go():
        jsrv, psrv = FakeRedisServer(), pf.FakeRedisServer()
        await jsrv.start()
        await psrv.start()
        try:
            got = {}
            for srv, cfg_extra, chans in ((jsrv, {"channels": ["events"]}, ["events"]),
                                          (psrv, {"channels": ["events"],
                                                  "patterns": ["sensor.*"]},
                                           ["events", "sensor.a", "sensor.b", "other"])):
                url = f"redis://127.0.0.1:{srv.port}"
                inputs = both("input", {"type": "redis", "url": url, "codec": "json",
                                        **cfg_extra})
                for inp in inputs:
                    await inp.connect()
                await asyncio.sleep(0.05)  # the SUBSCRIBEs land
                pub = RedisClient(url)
                await pub.connect()
                for i, ch in enumerate(chans):
                    await pub.publish(ch, json.dumps({"i": i}).encode())
                got[srv] = [[rows_of(b) for b in await read_all(inp, 0.2)] for inp in inputs]
                await pub.close()
                for inp in inputs:
                    await inp.close()
            j, p = got[jsrv], got[psrv]
            assert j[1] == j[0] and len(j[0]) == 1
            assert p[1] == p[0] and [r["__meta_ext_channel"][0] for r in p[0]] == [
                "events", "sensor.a", "sensor.b"]
        finally:
            stop(jsrv)
            psrv.server.close()

    run(go())


def test_redis_cluster_list_input_matches_jax():
    """List mode over a cluster: BLPOP routed to the keys' slot owner."""
    async def go():
        cluster = FakeCluster()
        await cluster.start()
        try:
            _, high = _keys_for_both_nodes()
            out = {}
            for kind in ("jax", "port"):
                # the high key's slot is the second node's; the seed is the first
                cluster.nodes[1].lists[high.encode()] = [b'{"a": 1}', b'{"a": 2}']
                cfg = {"type": "redis", "cluster": True, "urls": cluster.urls()[:1],
                       "mode": "list", "keys": [high], "codec": "json"}
                inp = (jax_build("input", cfg, JaxResource()) if kind == "jax"
                       else build_component("input", cfg, Resource()))
                await inp.connect()
                out[kind] = [rows_of((await asyncio.wait_for(inp.read(), 3))[0])
                             for _ in range(2)]
                await inp.close()
            assert out["port"] == out["jax"] and [r["a"] for r in out["port"]] == [[1], [2]]
        finally:
            stop(cluster)

    run(go())


@pytest.mark.parametrize("cfg", [
    {"type": "redis", "mode": "stream", "keys": ["k"]},
    {"type": "redis", "mode": "subscribe"},
    {"type": "redis", "mode": "list"},
    {"type": "redis", "cluster": True, "urls": ["redis://a:1"], "mode": "list",
     "keys": ["{a}.x", "{b}.y"]},
    {"type": "redis", "mode": "list", "keys": ["k"], "codec": "nope"},
], ids=["mode", "no_channels", "no_keys", "cross_slot", "codec"])
def test_redis_input_refusals_match_jax(cfg):
    if cfg.get("codec") == "nope":  # the codec registries differ in their lists
        with pytest.raises(JaxConfigError, match="unknown codec type 'nope'"):
            jax_build("input", cfg, JaxResource())
        with pytest.raises(ConfigError, match="unknown codec type 'nope'"):
            check_component("input", cfg)
        return
    refusals_match("input", cfg)


def test_redis_input_same_slot_keys_build_like_jax():
    cfg = {"type": "redis", "cluster": True, "urls": ["redis://a:1"], "mode": "list",
           "keys": ["{jobs}.high", "{jobs}.low"], "password": "pw"}
    j, p = both("input", cfg)
    assert (p.mode, p.keys, p.channels, p.patterns, p.client_config) == (
        j.mode, j.keys, j.channels, j.patterns, j.client_config)


# -- MQTT output -----------------------------------------------------------------------


@pytest.mark.parametrize("qos", [0, 1, 2])
def test_mqtt_output_matches_jax(qos):
    """Each output publishes the same batches to the JAX fake at ``qos``;
    a subscriber receives the same bytes from each, in order."""
    async def go():
        broker = FakeMqttBroker()
        await broker.start()
        try:
            seen: dict = {"jax": [], "port": []}
            sub = MqttClient("127.0.0.1", broker.port, client_id="sub")
            sub.on_message(lambda m: seen[m.topic.split("/")[-1]].append(m.payload))
            await sub.connect()
            await sub.subscribe("out/#", 1)
            for kind, cls in (("jax", JaxBatch), ("port", MessageBatch)):
                cfg = {"type": "mqtt", "host": f"127.0.0.1:{broker.port}",
                       "topic": {"value": f"out/{kind}"}, "qos": qos, "retain": True,
                       "client_id": f"out-{kind}", "codec": "json"}
                out = (jax_build("output", cfg, JaxResource()) if kind == "jax"
                       else build_component("output", cfg, Resource()))
                await out.connect()
                await out.write(cls.from_pydict({"a": [1, 2], "b": ["x", None]})
                                .with_source("t"))
                await out.write(cls.new_binary([b"raw"]))
                await out.close()
            await asyncio.sleep(0.1)
            await sub.close()
            assert seen["port"] == seen["jax"] and len(seen["port"]) == 3
        finally:
            stop(broker)

    run(go())


@pytest.mark.parametrize("cfg", [
    {"type": "mqtt"},
    {"type": "mqtt", "topic": "t", "qos": 5},
    {"type": "mqtt", "topic": {"nope": 1}},
], ids=["no_topic", "qos", "dyn"])
def test_mqtt_output_refusals_match_jax(cfg):
    refusals_match("output", cfg)


def test_mqtt_output_config_matches_jax(monkeypatch):
    monkeypatch.setenv("MQTT_OUT_PW", "pw")
    cfg = {"type": "mqtt", "host": "mqtt://h:1884", "topic": "t", "qos": 2, "retain": True,
           "username": "u", "password": "${MQTT_OUT_PW}"}
    j, p = both("output", cfg)
    keys = ("host", "port", "qos", "retain", "client_id", "username", "password")
    assert {k: getattr(p, k) for k in keys} == {k: getattr(j, k) for k in keys}
    # an {expr: ...} topic validates, builds and takes the batch's first row
    expr_cfg = {"type": "mqtt", "topic": {"expr": "concat('a', b)"}}
    check_component("output", expr_cfg)
    j, p = both("output", expr_cfg)
    assert p.topic.is_expr and j.topic.is_expr
    assert (p.topic.eval_scalar(MessageBatch.from_pydict({"b": ["x", "y"]}))
            == j.topic.eval_scalar(JaxBatch.from_pydict({"b": ["x", "y"]})) == "ax")


# -- HTTP output -------------------------------------------------------------------------


async def aiohttp_sink(statuses: list, delay_s: float = 0.0):
    """An aiohttp app answering ``statuses`` in turn (then 200), recording
    (method, Authorization, body) of each request."""
    from aiohttp import web

    seen: list = []

    async def handler(req):
        seen.append((req.method, req.headers.get("Authorization"), await req.read()))
        if delay_s:
            await asyncio.sleep(delay_s)
        status = statuses.pop(0) if statuses else 200
        return web.Response(status=status, text="ok" if status < 400 else "nope " * 60)

    app = web.Application()
    app.router.add_route("*", "/sink", handler)
    app.router.add_route("POST", "/api/v2/write", handler)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, site._server.sockets[0].getsockname()[1], seen


@pytest.mark.parametrize("batch_body,auth", [
    (True, {"type": "bearer", "token": "tk"}),
    (False, {"type": "basic", "username": "u", "password": "p"}),
], ids=["batch_bearer", "each_basic"])
def test_http_output_matches_jax(batch_body, auth):
    """The same batches through each output to an aiohttp sink answering
    200, 200, 503: the same requests (method, auth header, body) and the
    same WriteError text for the 503."""
    async def go():
        out = {}
        for kind, cls in (("jax", JaxBatch), ("port", MessageBatch)):
            runner, port, seen = await aiohttp_sink([200, 200, 503])
            try:
                cfg = {"type": "http", "url": f"http://127.0.0.1:{port}/sink", "method": "put",
                       "auth": auth, "headers": {"X-Extra": "1"}, "timeout": "2s",
                       "batch_body": batch_body, "codec": "json"}
                o = (jax_build("output", cfg, JaxResource()) if kind == "jax"
                     else build_component("output", cfg, Resource()))
                await o.connect()
                await o.write(cls.from_pydict({"a": [1, 2], "b": [0.5, None]}).with_source("s"))
                err = None
                try:
                    await o.write(cls.from_pydict({"a": [3]}))
                    await o.write(cls.from_pydict({"a": [4]}))
                except (WriteError, JaxWriteError) as e:
                    err = str(e)
                await o.close()
                out[kind] = (seen, err)
            finally:
                await runner.cleanup()
        return out

    out = run(go())
    assert out["port"] == out["jax"]
    seen, err = out["port"]
    assert err is not None and err.startswith("http output 503: nope nope") and len(err) == 217
    assert seen[0][0] == "PUT" and seen[0][1].startswith("Bearer " if batch_body else "Basic ")


def test_http_output_timeout_and_refused_connection():
    """A sink slower than ``timeout`` and a closed port: the port raises
    WriteError for both (the JAX output lets aiohttp's timeout out as a
    bare TimeoutError, ROADMAP Queue C)."""
    async def go():
        runner, port, _ = await aiohttp_sink([], delay_s=0.5)
        try:
            out = build_component("output", {"type": "http", "url": f"http://127.0.0.1:{port}/sink",
                                             "timeout": "100ms"}, Resource())
            await out.connect()
            with pytest.raises(WriteError, match="http output failed: .*timed out"):
                await out.write(MessageBatch.new_binary([b"x"]))
            await out.close()
        finally:
            await runner.cleanup()
        out = build_component("output", {"type": "http", "url": f"http://127.0.0.1:{port}/sink"},
                              Resource())
        await out.connect()
        with pytest.raises(WriteError, match="http output failed: cannot connect"):
            await out.write(MessageBatch.new_binary([b"x"]))

    run(go())


@pytest.mark.parametrize("cfg", [
    {"type": "http"},
    {"type": "http", "url": "http://h/x", "auth": {"type": "bearer"}},
    {"type": "http", "url": "http://h/x", "timeout": "soon"},
], ids=["no_url", "auth", "timeout"])
def test_http_output_refusals_match_jax(cfg):
    refusals_match("output", cfg)


# -- InfluxDB output ---------------------------------------------------------------------


_cell = st.one_of(st.none(), st.booleans(), st.integers(-2**40, 2**40),
                  st.floats(allow_nan=False, allow_infinity=False, width=64),
                  st.text(alphabet=st.sampled_from('ab ,=\\"x\u00e9'), max_size=6))


@st.composite
def influx_batches(draw):
    n = draw(st.integers(1, 5))
    kinds = draw(st.lists(st.sampled_from(["bool", "int", "float", "str", "mixed_none"]),
                          min_size=3, max_size=3))
    cols = {}
    for name, kind in zip(("t", "f", "g"), kinds):
        elem = {"bool": st.booleans(), "int": st.integers(-2**40, 2**40),
                "float": st.floats(allow_nan=False, allow_infinity=False),
                "str": st.text(alphabet=st.sampled_from('ab ,=\\"x\u00e9'), max_size=6),
                "mixed_none": st.one_of(st.none(), st.integers(0, 9))}[kind]
        cols[name] = draw(st.lists(elem, min_size=n, max_size=n))
    cols["ts"] = draw(st.lists(st.one_of(st.none(), st.integers(0, 2**50)), min_size=n,
                               max_size=n))
    return cols


@settings(max_examples=60, deadline=None)
@given(cols=influx_batches(), measurement=st.text(alphabet="m ,=x", min_size=1, max_size=5))
def test_encode_lines_matches_jax(cols, measurement):
    from arkflow_tpu.plugins.output.influxdb import encode_lines as jax_encode

    tags, fields = {"tag x": "t", "t2": "missing"}, {"f,1": "f", "g": "g", "t": "t"}
    want = jax_encode(JaxBatch.from_pydict(cols), measurement, tags, fields, "ts")
    got = port_influx.encode_lines(MessageBatch.from_pydict(cols), measurement, tags, fields,
                                   "ts")
    assert got == want


def test_encode_lines_jax_cases():
    cols = {"station": ["eu 1", "us,2"], "value": [1.5, 2], "ok": [True, False],
            "ts": [100, 200], "raw": [b"a\"b", b"c"]}
    lines = port_influx.encode_lines(MessageBatch.from_pydict(cols), "m1",
                                     {"station": "station"},
                                     {"value": "value", "ok": "ok", "raw": "raw"}, "ts")
    assert lines == ['m1,station=eu\\ 1 value=1.5,ok=true,raw="a\\"b" 100',
                     'm1,station=us\\,2 value=2.0,ok=false,raw="c" 200']


def test_influx_output_matches_jax():
    """A 500 then 204s from an aiohttp sink: each output retries once and
    writes the same bodies with the same ``Token`` header; the flusher
    writes a short batch; ``close`` flushes what is pending; past its
    retries an output re-queues its lines and raises JAX's message."""
    async def go():
        out = {}
        for kind, cls in (("jax", JaxBatch), ("port", MessageBatch)):
            runner, port, seen = await aiohttp_sink([500])
            try:
                cfg = {"type": "influxdb", "url": f"http://127.0.0.1:{port}/", "org": "o",
                       "bucket": "b", "token": "tok", "measurement": {"value": "m"},
                       "tags": {"st": "st"}, "fields": {"v": "v"}, "batch_size": 3,
                       "flush_interval": "50ms", "retries": 2}
                o = (jax_build("output", cfg, JaxResource()) if kind == "jax"
                     else build_component("output", cfg, Resource()))
                await o.connect()
                await o.write(cls.from_pydict({"st": ["a", "b", "c"], "v": [1.0, 2, 3.5]}))
                await o.write(cls.from_pydict({"st": ["d"], "v": [4]}))
                await asyncio.sleep(0.12)  # the flusher's turn
                await o.write(cls.from_pydict({"st": ["e"], "v": [None]}))
                await o.write(cls.from_pydict({"st": ["f"], "v": [True]}))
                await o.close()
                out[kind] = list(seen)
            finally:
                await runner.cleanup()
        return out

    out = run(go())
    assert out["port"] == out["jax"]
    assert [s[2] for s in out["port"]] == [b"m,st=a v=1.0\nm,st=b v=2.0\nm,st=c v=3.5"] * 2 + [
        b"m,st=d v=4i", b"m,st=f v=true"]
    assert {s[1] for s in out["port"]} == {"Token tok"}


def test_influx_output_requeues_and_raises_like_jax():
    async def go():
        msgs = {}
        for kind, cls in (("jax", JaxBatch), ("port", MessageBatch)):
            runner, port, seen = await aiohttp_sink([502, 503])
            try:
                cfg = {"type": "influxdb", "url": f"http://127.0.0.1:{port}", "org": "o",
                       "bucket": "b", "token": "t", "measurement": "m", "fields": {"v": "v"},
                       "batch_size": 1, "retries": 1, "flush_interval": "10s"}
                o = (jax_build("output", cfg, JaxResource()) if kind == "jax"
                     else build_component("output", cfg, Resource()))
                await o.connect()
                with pytest.raises((WriteError, JaxWriteError)) as e:
                    await o.write(cls.from_pydict({"v": [1]}))
                msgs[kind] = (str(e.value), list(o._pending))
                await o.close()  # the re-queued line goes out now
                msgs[kind] += ([s[2] for s in seen],)
            finally:
                await runner.cleanup()
        return msgs

    msgs = run(go())
    assert msgs["port"] == msgs["jax"]
    assert msgs["port"][0].startswith("influxdb write failed after 2 attempts: influxdb 503")
    assert msgs["port"][1] == ["m v=1i"] and msgs["port"][2] == [b"m v=1i"] * 3


def test_influx_retry_goes_out_before_later_lines_where_jax_lets_them_overtake():
    """The flusher's write of line ``a`` is answered 500 and backs off
    0.2 s; a write of ``b`` and ``c`` then fills a batch. JAX's output
    posts them at once, before ``a``'s retry; the port's waits for the
    flush in its retries, so the lines keep their order (ROADMAP Queue C)."""
    async def go():
        out = {}
        for kind, cls in (("jax", JaxBatch), ("port", MessageBatch)):
            runner, port, seen = await aiohttp_sink([500])
            try:
                cfg = {"type": "influxdb", "url": f"http://127.0.0.1:{port}", "org": "o",
                       "bucket": "b", "token": "t", "measurement": "m", "fields": {"v": "v"},
                       "batch_size": 2, "flush_interval": "50ms", "retries": 1}
                o = (jax_build("output", cfg, JaxResource()) if kind == "jax"
                     else build_component("output", cfg, Resource()))
                await o.connect()
                await o.write(cls.from_pydict({"v": ["a"]}))
                while not seen:  # the flusher's first post, answered 500
                    await asyncio.sleep(0.005)
                await asyncio.sleep(0.03)  # inside its 0.2 s backoff
                await o.write(cls.from_pydict({"v": ["b", "c"]}))
                while len(seen) < 3:  # JAX's retry of a, still backing off
                    await asyncio.sleep(0.005)
                await o.close()
                out[kind] = [s[2] for s in seen]
            finally:
                await runner.cleanup()
        return out

    a, bc = b'm v="a"', b'm v="b"\nm v="c"'
    assert run(go()) == {"jax": [a, bc, a], "port": [a, a, bc]}


@pytest.mark.parametrize("missing", ["url", "org", "bucket", "token", "measurement", "fields"])
def test_influx_output_refusals_match_jax(missing):
    cfg = {"type": "influxdb", "url": "http://h", "org": "o", "bucket": "b", "token": "t",
           "measurement": "m", "fields": {"v": "v"}}
    cfg.pop(missing)
    assert refusals_match("output", cfg) == f"influxdb output requires {missing!r}"


# -- websocket input ----------------------------------------------------------------------


def test_websocket_input_matches_jax():
    """A ``websockets`` server sends text, binary, a fragmented message, a
    126- and a 127-length one and pings between them, then closes: each
    input reads the same batches, then raises Disconnection; the pings were
    answered."""
    import websockets

    pongs: list = []

    async def handler(ws):
        await ws.send('{"v": 1}')
        await ws.send(b'{"v": 2}')
        pongs.append(await ws.ping(b"p1"))
        await ws.send(iter(['{"v": ', '3, "frag": ', 'true}']))
        await ws.send(json.dumps({"v": 4, "pad": "y" * 300}))
        pongs.append(await ws.ping(b"p2"))
        await ws.send(json.dumps({"v": 5, "pad": "z" * 70000}).encode())
        await asyncio.sleep(0.1)
        await ws.close()

    async def go():
        async with websockets.serve(handler, "127.0.0.1", 0) as server:
            port = server.sockets[0].getsockname()[1]
            out = {}
            for kind in ("jax", "port"):
                cfg = {"type": "websocket", "url": f"ws://127.0.0.1:{port}/feed", "codec": "json"}
                inp = (jax_build("input", cfg, JaxResource()) if kind == "jax"
                       else build_component("input", cfg, Resource()))
                await inp.connect()
                got = [rows_of((await asyncio.wait_for(inp.read(), 3))[0]) for _ in range(5)]
                with pytest.raises((Disconnection, JaxDisconnection), match="websocket closed"):
                    await asyncio.wait_for(inp.read(), 3)
                await inp.close()
                with pytest.raises((EndOfInput, JaxEndOfInput)):
                    await inp.read()
                out[kind] = got
            await asyncio.wait_for(asyncio.gather(*pongs), 2)  # every ping answered
        return out

    out = run(go())
    assert out["port"] == out["jax"]
    assert [r["v"] for r in out["port"]] == [[1], [2], [3], [4], [5]]
    assert out["port"][2]["frag"] == [True] and out["port"][0]["__meta_source"] == ["websocket"]


def test_websocket_input_refusals_match_jax():
    refusals_match("input", {"type": "websocket"})
    j, p = both("input", {"type": "websocket", "url": "ws://h:1/x"})
    assert p.url == j.url


# -- Modbus input --------------------------------------------------------------------------


def test_modbus_input_matches_jax():
    """The JAX fake's coils and registers: one row a poll, a column a point,
    lists where ``count`` > 1, typed as JAX's (``schema``)."""
    async def go():
        srv = FakeModbusServer()
        await srv.start()
        try:
            cfg = {"type": "modbus", "host": "127.0.0.1", "port": srv.port, "interval": "1ms",
                   "unit": 3, "points": [
                       {"name": "pump_on", "kind": "coil", "address": 0},
                       {"name": "bits", "kind": "discrete", "address": 1, "count": 3},
                       {"name": "temps", "kind": "holding", "address": 0, "count": 3},
                       {"name": "level", "kind": "input", "address": 2}]}
            out = {}
            for kind, inp in zip(("jax", "port"), both("input", cfg)):
                await inp.connect()
                batches = [(await asyncio.wait_for(inp.read(), 3))[0] for _ in range(2)]
                await inp.close()
                with pytest.raises((EndOfInput, JaxEndOfInput)):
                    await inp.read()
                out[kind] = ([rows_of(b) for b in batches],
                             {n: str(t) for n, t in zip(batches[0].schema.names,
                                                        batches[0].schema.types)}
                             if kind == "jax" else batches[0].schema)
            return out
        finally:
            stop(srv)

    out = run(go())
    assert out["port"] == out["jax"]
    assert out["port"][0][0]["temps"] == [[100, 200, 300]]
    assert out["port"][0][0]["bits"] == [[False, True, True]]
    assert out["port"][1]["temps"] == "list<item: int64>"


@pytest.mark.parametrize("points", [
    [], [{"name": "x", "kind": "bogus", "address": 0}], [{"kind": "coil", "address": 0}],
    [{"name": "x", "kind": "holding", "address": 0, "count": 0}],
    [{"name": "x", "kind": "holding", "address": 0, "count": 200}],
    [{"name": "x", "kind": "coil", "address": 0, "count": 2001}],
], ids=["none", "kind", "name", "count0", "count200", "bits2001"])
def test_modbus_refusals_match_jax(points):
    refusals_match("input", {"type": "modbus", "host": "h", "points": points})


def test_modbus_needs_host_like_jax():
    refusals_match("input", {"type": "modbus", "points": [
        {"name": "x", "kind": "coil", "address": 0}]})


# -- multiple_inputs ----------------------------------------------------------------------


def test_multiple_inputs_match_jax_names_and_end():
    """``windowed_join_example.yaml``'s fan-in of two memory inputs, a third
    unnamed: the same batches (child order interleaves, so compared as
    sets), sources stamped by name, the same ``Resource.input_names``, and
    EndOfInput once every child ended."""
    with open(ROOT / "examples" / "windowed_join_example.yaml") as f:
        cfg = yaml.safe_load(f)["streams"][0]["input"]
    cfg = json.loads(json.dumps(cfg))
    cfg["inputs"].append({"type": "memory", "messages": ["x", "y"]})

    async def go():
        out = {}
        for kind in ("jax", "port"):
            res = JaxResource() if kind == "jax" else Resource()
            inp = (jax_build("input", cfg, res) if kind == "jax"
                   else build_component("input", cfg, res))
            await inp.connect()
            got = []
            with pytest.raises((EndOfInput, JaxEndOfInput)):
                while True:
                    batch, ack = await asyncio.wait_for(inp.read(), 3)
                    await ack.ack()
                    got.append(json.dumps(rows_of(batch), sort_keys=True, default=str))
            await inp.close()
            out[kind] = (sorted(got), res.input_names)
        return out

    out = run(go())
    assert out["port"] == out["jax"]
    assert out["port"][1] == ["orders", "users", "input_2"]
    sources = {json.loads(r)["__meta_source"][0] for r in out["port"][0]}
    assert sources == {"orders", "users", "input_2"} and len(out["port"][0]) == 6


def test_multiple_inputs_failing_child_is_counted_out_like_jax():
    """A child whose read raises is logged and counted out: the other
    child's batches still arrive, then EndOfInput, in both packages."""
    from arkflow_tpu.components import Input as JaxInput
    from arkflow_tpu.plugins.input.multiple_inputs import MultipleInputs as JaxMulti
    from arkflow_tpu_torch.components import Input
    from arkflow_tpu_torch.plugins.input.multiple_inputs import MultipleInputs

    def failing(base):
        class Failing(base):
            async def connect(self):
                return None

            async def read(self):
                raise RuntimeError("broken child")

        return Failing()

    async def go():
        out = {}
        for kind in ("jax", "port"):
            if kind == "jax":
                ok = jax_build("input", {"type": "memory", "messages": ["a", "b"]}, JaxResource())
                inp = JaxMulti([("bad", failing(JaxInput)), ("ok", ok)])
            else:
                ok = build_component("input", {"type": "memory", "messages": ["a", "b"]},
                                     Resource())
                inp = MultipleInputs([("bad", failing(Input)), ("ok", ok)])
            await inp.connect()
            got = []
            with pytest.raises((EndOfInput, JaxEndOfInput)):
                while True:
                    batch, _ = await asyncio.wait_for(inp.read(), 3)
                    got.append(rows_of(batch))
            await inp.close()
            out[kind] = got
        return out

    out = run(go())
    assert out["port"] == out["jax"] and [r["__value__"] for r in out["port"]] == [[b"a"], [b"b"]]


@pytest.mark.parametrize("cfg", [
    {"type": "multiple_inputs"}, {"type": "multiple_inputs", "inputs": []},
    {"type": "multiple_inputs", "inputs": {"a": 1}},
    {"type": "multiple_inputs", "inputs": [{"type": "websocket"}]},
], ids=["none", "empty", "mapping", "child"])
def test_multiple_inputs_refusals_match_jax(cfg):
    refusals_match("input", cfg)


def test_multiple_inputs_child_key_not_ported():
    """A child's ``tenant`` (once refused here) now stamps its batches as
    JAX's memory child does; an unknown child key is still refused."""
    cfg = {"type": "multiple_inputs", "inputs": [
        {"type": "memory", "messages": ["a"], "tenant": "t"}]}
    check_component("input", cfg)

    async def go(inp):
        await inp.connect()
        batch, _ = await inp.read()
        await inp.close()
        return batch.to_pydict()

    j, p = both("input", cfg)
    assert run(go(p)) == run(go(j))
    assert run(go(p))["__meta_ext_tenant"] == ["t"]
    with pytest.raises(ConfigError, match="'tenants' is not yet ported"):
        check_component("input", {"type": "multiple_inputs", "inputs": [
            {"type": "memory", "messages": ["a"], "tenants": 2}]})


# -- overload flags, the JAX configs ----------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    {"type": "kafka", "brokers": "b:1", "topics": ["t"], "group": "g"},
    {"type": "http", "port": 0},
    {"type": "mqtt", "host": "h", "topics": ["t"]},
    {"type": "memory", "messages": ["a"]},
    {"type": "generate", "payload": "x"},
    {"type": "redis", "mode": "list", "keys": ["k"]},
    {"type": "redis", "mode": "subscribe", "channels": ["c"]},
    {"type": "nats", "subject": "s"},
    {"type": "nats", "mode": "jetstream", "stream": "S", "durable": "d"},
    {"type": "websocket", "url": "ws://h/x"},
    {"type": "modbus", "host": "h", "points": [{"name": "x", "kind": "coil", "address": 0}]},
    {"type": "multiple_inputs", "inputs": [{"type": "memory", "messages": ["a"]}]},
], ids=lambda c: c["type"] + ("_" + c["mode"] if "mode" in c else ""))
def test_pause_on_overload_matches_jax(cfg):
    j, p = both("input", cfg)
    assert bool(getattr(p, "pause_on_overload", False)) == bool(
        getattr(j, "pause_on_overload", False))


JAX_EXAMPLES = ["nats_jetstream_example", "websocket_example", "modbus_example",
                "redis_cluster_example", "windowed_join_example", "mqtt_qos2_example"]
NEW_TYPES = {"input": ("nats", "redis", "websocket", "modbus", "multiple_inputs"),
             "output": ("mqtt", "http", "influxdb", "nats", "redis")}


@pytest.mark.parametrize("name", JAX_EXAMPLES)
def test_jax_example_ends_build_or_refuse_alike(name):
    """Each input and output of these types in the JAX examples builds in
    both packages with the same attributes, or both refuse it with JAX's
    message. ``modbus_example.yaml``'s influxdb output has a ``database``
    key that neither reads: the port names it as not carried; without it
    both refuse with JAX's "requires 'org'"."""
    with open(ROOT / "examples" / f"{name}.yaml") as f:
        streams = yaml.safe_load(f)["streams"]
    seen = 0
    for s in streams:
        for family in ("input", "output"):
            cfg = s[family]
            if cfg["type"] not in NEW_TYPES[family]:
                continue
            seen += 1
            if "database" in cfg:
                with pytest.raises(ConfigError, match="'database' is not yet ported"):
                    check_component(family, cfg)
                cfg = {k: v for k, v in cfg.items() if k != "database"}
            try:
                j = jax_build(family, cfg, JaxResource())
            except JaxConfigError:
                refusals_match(family, cfg)
                continue
            p = build_component(family, cfg, Resource())
            assert type(p).__name__ == type(j).__name__
            keys = {k for k in vars(j) if not k.startswith("_") and k not in (
                "codec", "children", "topic", "subject", "target", "measurement")}
            assert {k: getattr(p, k) for k in keys} == {k: getattr(j, k) for k in keys}
    assert seen


@pytest.mark.parametrize("name", ["nats_bert_mqtt", "redis_lstm_influx", "ws_redis_bert_http",
                                  "modbus_influx"])
def test_new_examples_validate_and_name_their_yaml(name, capsys):
    path = ROOT / "arkflow_tpu_torch" / "examples" / f"{name}.json"
    assert cli.main(["--config", str(path), "--validate"]) == 0
    assert "config OK" in capsys.readouterr().out
    with open(path) as f:
        raw = json.load(f)
    yamls = {"nats_bert_mqtt": "nats_jetstream_example", "redis_lstm_influx":
             "redis_cluster_example", "ws_redis_bert_http": "websocket_example",
             "modbus_influx": "modbus_example"}
    assert f"examples/{yamls[name]}.yaml" in raw["description"]
    with open(ROOT / "examples" / f"{yamls[name]}.yaml") as f:
        jax_in = yaml.safe_load(f)["streams"][0]["input"]
    port_in = raw["streams"][0]["input"]
    if port_in["type"] == "multiple_inputs":
        port_in = port_in["inputs"][0]
    for key in ("type", "mode", "stream", "durable", "subject", "batch_size", "keys", "codec",
                "port", "points"):
        if key in jax_in and key != "points":
            assert port_in[key] == jax_in[key], key


# -- the examples on the CPU, over the port's fakes -------------------------------------------


TINY = {"vocab_size": 128, "hidden": 16, "layers": 1, "heads": 2, "ffn": 32,
        "max_positions": 64}
TINY_LSTM = {"features": 2, "hidden": 8, "latent": 4, "window": 8}
TEXTS = [{"id": i, "text": f"msg{i} " + "w " * (i % 9)} for i in range(24)]


def example(name: str, **proc) -> dict:
    with open(ROOT / "arkflow_tpu_torch" / "examples" / f"{name}.json") as f:
        raw = json.load(f)
    if proc:
        raw["streams"][0]["pipeline"]["processors"][0].update(device="cpu", **proc)
    return raw


def check_rows(rows: list, ids: list) -> None:
    rows = [json.loads(r) for r in rows]
    assert all(list(r) == ["id", "label", "score"] for r in rows)
    assert sorted(r["id"] for r in rows) == sorted(ids)
    assert all(0.0 <= r["score"] <= 1.0 and r["label"] in (0, 1) for r in rows)


def test_nats_bert_mqtt_example_runs_on_cpu():
    raw = example("nats_bert_mqtt", model_config=TINY, max_seq=32, batch_buckets=[4, 8],
                  seq_buckets=[32], warmup=False)
    s = raw["streams"][0]
    s["input"]["batch_size"] = 8
    s["buffer"].update(capacity=8)
    s["buffer"]["coalesce"].update(batch_buckets=[8], token_budget=256, max_row_tokens=32)
    rep = run(bs.nats_to_mqtt(raw, [json.dumps(t).encode() for t in TEXTS]), 30)
    check_rows(rep["payloads"], [t["id"] for t in TEXTS])
    assert [json.loads(p)["id"] for p in rep["payloads"]] == [t["id"] for t in TEXTS]
    assert rep["ack_floor"] == rep["last_seq"] == len(TEXTS) and rep["redelivered"] == 0
    assert rep["errors"] == 0 and rep["ack_pending"] == 0


def test_redis_lstm_influx_example_runs_on_cpu():
    raw = example("redis_lstm_influx", model_config=TINY_LSTM, batch_buckets=[4, 8])
    windows = np.random.default_rng(0).random((20, 16)).round(3)
    payloads = [json.dumps({"id": i, "window": w.tolist()}).encode()
                for i, w in enumerate(windows)]
    rep = run(bs.redis_to_influx(raw, payloads, statuses=[500]), 30)
    assert [line.split(b" ")[0] for line in rep["lines"]] == [
        b"windows,id=%d" % i for i in range(20)]
    scores = [float(line.split(b"score=")[1]) for line in rep["lines"]]
    assert all(math.isfinite(x) and x >= 0 for x in scores)
    assert rep["answered"][:2] == [500, 204] and rep["answered"].count(500) == 1
    assert rep["bodies"][0] == rep["bodies"][1]  # the retry resent the same lines
    assert rep["authorization"] == ["Token dev-token"] and rep["left_in_lists"] == 0


def test_ws_redis_bert_http_example_runs_on_cpu():
    raw = example("ws_redis_bert_http", model_config=TINY, max_seq=32, batch_buckets=[4, 8],
                  seq_buckets=[16, 32], warmup=False)
    rep = run(bs.ws_redis_to_http(raw, [json.dumps(t) for t in TEXTS[:12]],
                                  [json.dumps(t).encode() for t in TEXTS[12:]]), 30)
    check_rows(rep["rows"], [t["id"] for t in TEXTS])
    assert {h["authorization"] for h in rep["headers"]} == {"Bearer dev-token"}
    assert set(rep["answered"]) == {200} and rep["connections"] == 1
    assert rep["ws_handshakes"] == 1 and rep["redis_published"] == 12


def test_modbus_influx_example_runs_on_cpu():
    raw = example("modbus_influx")
    raw["streams"][0]["input"]["interval"] = "5ms"
    raw["streams"][0]["output"]["flush_interval"] = "50ms"
    rep = run(bs.modbus_to_influx(raw, 8), 30)
    points = raw["streams"][0]["input"]["points"]
    served = rep["served"]
    for i, line in enumerate(rep["lines"]):
        row = {p["name"]: [served[3 * i + j][3][0]] for j, p in enumerate(points)}
        assert line.decode() == port_influx.encode_lines(
            MessageBatch.from_pydict(row), "plc", {}, {p["name"]: p["name"] for p in points},
            None)[0]
    assert len(rep["lines"]) >= 8 and rep["errors"] == 0


def test_influx_output_requeues_after_a_timeout():
    """A write that times out is retried and re-queued like any failed
    write (the JAX output lets aiohttp's timeout out as a bare TimeoutError
    and loses the lines, ROADMAP Queue C)."""
    async def go():
        async def silent(reader, writer):
            await asyncio.sleep(2)

        server = await asyncio.start_server(silent, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        out = build_component("output", {
            "type": "influxdb", "url": f"http://127.0.0.1:{port}", "org": "o", "bucket": "b",
            "token": "t", "measurement": "m", "fields": {"v": "v"}, "batch_size": 1,
            "retries": 0}, Resource())
        await out.connect()
        out._client.timeout_s = 0.1
        with pytest.raises(WriteError, match="after 1 attempts: .*timed out after 0.1 s"):
            await out.write(MessageBatch.from_pydict({"v": [2.5]}))
        pending = list(out._pending)
        out._pending.clear()
        await out.close()
        server.close()
        return pending

    assert run(go()) == ["m v=2.5"]
