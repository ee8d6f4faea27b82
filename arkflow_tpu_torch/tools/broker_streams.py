"""Drive the broker examples end to end against ``fake_brokers``.

Each driver takes an engine config of one of the examples
(``examples/kafka_bert_kafka.json``, ``mqtt_lstm_anomaly.json``,
``http_vit_redis.json``, ``cdc_llm_nats.json``, ``nats_bert_mqtt.json``,
``redis_lstm_influx.json``, ``ws_redis_bert_http.json``,
``modbus_influx.json``, ``file_bert_pulsar.json``, ``pulsar_example.json``,
``avro_file_example.json``), points its input and output at fakes started on
127.0.0.1 in the same process, feeds the input, runs the stream through
``Engine`` until its output holds every expected row (a count: the push
inputs never end), stops it (``Engine.shutdown``: the stream drains and
acks before it closes) and returns what the output received with the
stream's counters (the file examples' input ends by itself: their drivers
run the stream to its end):

    report = asyncio.run(kafka_to_kafka(raw, texts, codecs=["gzip", "snappy"]))
    report["values"], report["committed"], report["log_end"], report["rows_per_s"]

``prepare(stream)``, when given, runs after the build and before the run
(the smoke swaps a warm runner in there). ``kafka_to_kafka`` also takes
``feed(engine)``, a coroutine run beside the stream (the smoke's ``obs``
part scrapes the engine's health server there); the engine stops only
after it returned. A stream that ends early, or an
output that does not complete within ``timeout_s``, raises; so does a fake
that fails to bind. Nothing here imports JAX or a broker library.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import time
from typing import Awaitable, Callable, Optional

from arkflow_tpu_torch.config import EngineConfig
from arkflow_tpu_torch.connect.kafka_client import KafkaClient
from arkflow_tpu_torch.connect.mqtt_client import MqttClient
from arkflow_tpu_torch.connect.nats_client import NatsClient
from arkflow_tpu_torch.connect.pulsar_client import validate_topic
from arkflow_tpu_torch.connect.redis_client import RedisClient
from arkflow_tpu_torch.runtime.engine import Engine
from arkflow_tpu_torch.tools.fake_brokers import (FakeKafkaBroker, FakeModbusServer,
                                                  FakeMqttBroker, FakeNatsServer,
                                                  FakePulsarBroker, FakeRedisServer,
                                                  FakeWebsocketServer, HttpSink)

Prepare = Optional[Callable[[object], None]]

#: records of one produce request when seeding a topic
PRODUCE_CHUNK = 256


class StreamFailed(RuntimeError):
    """A broker stream ended early, or its output did not complete."""


def _copy(raw: dict) -> dict:
    return json.loads(json.dumps(raw))


def _build(raw: dict, prepare: Prepare):
    engine = Engine(EngineConfig.from_mapping(raw))
    stream = engine.build()[0]
    if prepare is not None:
        prepare(stream)
    return engine, stream


async def run_until(engine: Engine, done: Callable[[], bool],
                    feed: Optional[Callable[[], Awaitable[None]]] = None,
                    timeout_s: float = 120.0) -> float:
    """Run ``engine`` until ``done()``, with ``feed`` running beside it; the
    wall seconds from the start to ``done()``. A stream error (a failed
    batch, write or read) ends the run at once."""
    t0 = time.perf_counter()
    task = asyncio.create_task(engine.run())
    feeder = asyncio.create_task(feed()) if feed is not None else None
    try:
        while not done():
            if task.done():
                task.result()
                raise StreamFailed("the stream ended before its output was complete")
            errors = {s.name: s.errors for s in engine.streams if s.errors}
            if errors:
                raise StreamFailed(f"the stream reported errors: {errors}")
            if feeder is not None and feeder.done():
                feeder.result()  # a feeding error ends the run here
            if time.perf_counter() - t0 > timeout_s:
                raise StreamFailed(f"the stream's output did not complete in {timeout_s} s")
            await asyncio.sleep(0.005)
        wall = time.perf_counter() - t0
        if feeder is not None:
            await asyncio.wait_for(feeder, timeout_s)
    finally:
        if feeder is not None and not feeder.done():
            feeder.cancel()
        engine.shutdown()
        await asyncio.wait_for(task, timeout_s)
    return wall


def _stream_report(stream, wall: float) -> dict:
    traffic = stream.traffic_seconds or wall
    return {"rows_out": stream.rows_out, "errors": stream.errors, "wall_s": wall,
            "traffic_seconds": traffic, "rows_per_s": stream.rows_out / traffic}


async def _seed_kafka(broker: FakeKafkaBroker, topic: str, partitions: int,
                      values: list[bytes], codecs: list) -> None:
    """Value ``i`` to partition ``i % partitions``, each partition in
    produce requests of ``PRODUCE_CHUNK`` records compressed with
    ``codecs[p % len(codecs)]``."""
    client = KafkaClient(f"127.0.0.1:{broker.port}")
    await client.connect()
    await client.refresh_metadata([topic])
    try:
        for p in range(partitions):
            part = values[p::partitions]
            for i in range(0, len(part), PRODUCE_CHUNK):
                await client.produce(topic, p, [(None, v) for v in part[i:i + PRODUCE_CHUNK]],
                                     compression=codecs[p % len(codecs)] if codecs else None)
    finally:
        await client.close()


async def kafka_to_kafka(raw: dict, values: list[bytes], partitions: int = 4,
                         codecs: Optional[list] = None, prepare: Prepare = None,
                         timeout_s: float = 120.0,
                         feed: Optional[Callable[[Engine], Awaitable[None]]] = None) -> dict:
    """``kafka_bert_kafka.json``: ``values`` produced into the input topic
    before the run; the stream stops once the output topic holds one record
    a value and the group's committed offsets reach each partition's log
    end."""
    raw = _copy(raw)
    s = raw["streams"][0]
    in_topic, out_topic, group = s["input"]["topic"], s["output"]["topic"], s["input"]["group"]
    broker = FakeKafkaBroker({in_topic: partitions, out_topic: partitions})
    await broker.start()
    try:
        s["input"]["brokers"] = s["output"]["brokers"] = f"127.0.0.1:{broker.port}"
        await _seed_kafka(broker, in_topic, partitions, values, codecs or [])
        engine, stream = _build(raw, prepare)
        ends = [broker.log_end(in_topic, p) for p in range(partitions)]
        generation: dict = {}

        def done() -> bool:
            if "before" not in generation and broker.generation(group):
                generation["before"] = broker.generation(group)
            out = sum(broker.log_end(out_topic, p) for p in range(partitions))
            return out >= len(values) and all(
                broker.group_offsets.get((group, in_topic, p)) == ends[p]
                for p in range(partitions))

        wall = await run_until(engine, done, (lambda: feed(engine)) if feed else None,
                               timeout_s=timeout_s)
        records = [r for p in range(partitions) for r in broker.records(out_topic, p)]
        return {**_stream_report(stream, wall),
                "values": [r.value for r in records], "keys": [r.key for r in records],
                "partitions_out": [p for p in range(partitions)
                                   for _ in broker.records(out_topic, p)],
                "committed": [broker.group_offsets.get((group, in_topic, p))
                              for p in range(partitions)],
                "log_end": ends, "generation_before": generation.get("before"),
                "generation_after": broker.generation(group),
                "input_codecs": sorted({c for p in range(partitions)
                                        for c in broker.codecs_seen.get((in_topic, p), ())}),
                "output_codecs": sorted({c for p in range(partitions)
                                         for c in broker.codecs_seen.get((out_topic, p), ())})}
    finally:
        await broker.stop()


def count_filtered(stream) -> list[int]:
    """A one-item counter of the rows the stream's processors drop (a
    ``remap`` or ``sql`` filter): each processor's ``process`` is wrapped to
    add its input rows less its output rows."""
    dropped = [0]
    for proc in stream.pipeline.processors:
        inner = proc.process

        async def process(batch, inner=inner):
            outs = await inner(batch)
            dropped[0] += batch.num_rows - sum(b.num_rows for b in outs)
            return outs

        proc.process = process
    return dropped


async def mqtt_to_stdout(raw: dict, payloads: list[bytes], qos: int = 1,
                         window: int = 256, prepare: Prepare = None,
                         timeout_s: float = 120.0) -> dict:
    """``mqtt_lstm_anomaly.json``: ``payloads`` published on
    ``sensors/dev<i % 8>`` at ``qos`` once the input subscribed, at most
    ``window`` ahead of the rows done (the input's queue drops past 1000, as
    the JAX input's does); the run ends once every row is a stdout line or
    was dropped by the ``remap`` filter. Returns the lines and the rows
    ``filtered``."""
    raw = _copy(raw)
    s = raw["streams"][0]
    broker = FakeMqttBroker()
    await broker.start()
    try:
        s["input"].update(host="127.0.0.1", port=broker.port)
        engine, stream = _build(raw, prepare)
        lines: list[bytes] = []
        stream.output._write = lines.append
        dropped = count_filtered(stream)

        def rows_done() -> int:
            return len(lines) + dropped[0]

        async def feed() -> None:
            while not broker.subs:
                await asyncio.sleep(0.005)
            pub = MqttClient("127.0.0.1", broker.port, client_id="arkflow-smoke-pub")
            await pub.connect()
            try:
                for i, p in enumerate(payloads):
                    while i - rows_done() >= window:
                        await asyncio.sleep(0.001)
                    await pub.publish(f"sensors/dev{i % 8}", p, qos=qos)
            finally:
                await pub.close()

        wall = await run_until(engine, lambda: rows_done() >= len(payloads), feed, timeout_s)
        return {**_stream_report(stream, wall), "lines": list(lines), "filtered": dropped[0],
                "published": broker.published}
    finally:
        await broker.stop()


def _post_all(port: int, path: str, bodies: list[bytes]) -> list[int]:
    """POST each body in turn on one keep-alive ``http.client`` connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    statuses = []
    try:
        for body in bodies:
            conn.request("POST", path, body=body,
                         headers={"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            resp.read()
            statuses.append(resp.status)
    finally:
        conn.close()
    return statuses


async def http_to_redis(raw: dict, bodies: list[bytes], extra: int = 0,
                        prepare: Prepare = None, timeout_s: float = 120.0) -> dict:
    """``http_vit_redis.json``: every body POSTed, then ``extra`` more
    copies of the first, on one keep-alive connection of a stdlib client;
    the statuses, the list at the ``rpush`` target and the connections the
    server accepted."""
    raw = _copy(raw)
    s = raw["streams"][0]
    srv = FakeRedisServer()
    await srv.start()
    try:
        s["input"].update(host="127.0.0.1", port=0)
        s["output"]["url"] = f"redis://127.0.0.1:{srv.port}"
        target = s["output"]["target"].encode()
        engine, stream = _build(raw, prepare)
        inp = stream.input
        statuses: list = []
        server: list = []

        async def feed() -> None:
            while inp._server is None:
                await asyncio.sleep(0.005)
            server.append(inp._server)
            statuses.extend(await asyncio.to_thread(
                _post_all, inp.port, s["input"].get("path", "/"), bodies + bodies[:1] * extra))

        n_ok = len(bodies)
        wall = await run_until(engine, lambda: len(srv.lists.get(target, [])) >= n_ok
                               and len(statuses) == len(bodies) + extra, feed, timeout_s)
        return {**_stream_report(stream, wall), "statuses": statuses,
                "values": list(srv.lists.get(target, [])),
                "connections": server[0].connections}
    finally:
        await srv.stop()


async def kafka_to_nats(raw: dict, values: list[bytes], prepare: Prepare = None,
                        timeout_s: float = 120.0) -> dict:
    """``cdc_llm_nats.json``: ``values`` produced into a one-partition input
    topic (one fetch, one batch, in order); the stream stops once every
    payload is on the subject and the group committed the log end; the
    payloads in arrival order."""
    raw = _copy(raw)
    s = raw["streams"][0]
    in_topic, group = s["input"]["topic"], s["input"]["group"]
    broker, nats = FakeKafkaBroker({in_topic: 1}), FakeNatsServer()
    await broker.start()
    await nats.start()
    sub = NatsClient(f"nats://127.0.0.1:{nats.port}")
    try:
        s["input"]["brokers"] = f"127.0.0.1:{broker.port}"
        s["output"]["url"] = f"nats://127.0.0.1:{nats.port}"
        await _seed_kafka(broker, in_topic, 1, values, [])
        await sub.connect()
        got: list[bytes] = []
        await sub.subscribe(s["output"]["subject"], lambda m: got.append(m.payload))
        engine, stream = _build(raw, prepare)
        end = broker.log_end(in_topic, 0)

        def done() -> bool:
            return (len(got) >= len(values)
                    and broker.group_offsets.get((group, in_topic, 0)) == end)

        wall = await run_until(engine, done, timeout_s=timeout_s)
        await asyncio.sleep(0.05)  # a duplicate publish would land by now
        return {**_stream_report(stream, wall), "payloads": list(got),
                "committed": broker.group_offsets.get((group, in_topic, 0)),
                "log_end": end, "generation_after": broker.generation(group)}
    finally:
        await sub.close()
        await broker.stop()
        await nats.stop()


async def nats_to_mqtt(raw: dict, values: list[bytes], prepare: Prepare = None,
                       timeout_s: float = 120.0) -> dict:
    """``nats_bert_mqtt.json``: ``values`` stored in the JetStream stream
    before the run, on the input's filter subject; the stream stops once an
    MQTT subscriber (QoS 1) holds one payload a value and the consumer's ack
    floor reaches the stream's last sequence; the payloads in arrival order
    and the consumer's counts."""
    raw = _copy(raw)
    s = raw["streams"][0]
    inp = s["input"]
    name, durable, subject = inp["stream"], inp["durable"], inp.get("subject") or "events"
    nats, broker = FakeNatsServer(streams={name: [subject]}), FakeMqttBroker()
    await nats.start()
    await broker.start()
    sub = MqttClient("127.0.0.1", broker.port, client_id="arkflow-smoke-sub")
    try:
        inp["url"] = f"nats://127.0.0.1:{nats.port}"
        s["output"].update(host="127.0.0.1", port=broker.port)
        for v in values:
            nats.js_publish(subject, v)
        got: list[bytes] = []
        sub.on_message(lambda m: got.append(m.payload))
        await sub.connect()
        await sub.subscribe(s["output"]["topic"], qos=1)
        engine, stream = _build(raw, prepare)
        last = nats.last_seq(name)

        def done() -> bool:
            c = nats.consumers.get((name, durable))
            return len(got) >= len(values) and c is not None and c.ack_floor == last

        wall = await run_until(engine, done, timeout_s=timeout_s)
        await asyncio.sleep(0.05)  # a duplicate publish would land by now
        c = nats.consumers[(name, durable)]
        return {**_stream_report(stream, wall), "payloads": list(got),
                "ack_floor": c.ack_floor, "last_seq": last, "redelivered": c.redelivered,
                "naks": c.naks, "ack_pending": len(c.pending),
                "published": broker.published}
    finally:
        await sub.close()
        await nats.stop()
        await broker.stop()


def sink_lines(sink: HttpSink) -> list[bytes]:
    """The lines of the request bodies a sink answered with a 2xx."""
    return [line for (_, _, _, body), status in zip(sink.requests, sink.answered)
            if 200 <= status < 300 for line in body.split(b"\n") if line]


async def redis_to_influx(raw: dict, values: list[bytes], statuses: Optional[list] = None,
                          prepare: Prepare = None, timeout_s: float = 120.0) -> dict:
    """``redis_lstm_influx.json``: the first half of ``values`` pushed onto
    the input's first key, the rest onto its last (BLPOP drains its keys in
    order, so the stream reads ``values`` in order); an InfluxDB sink
    answering ``statuses`` first, then 204; the stream stops once the sink
    took one line a value. The lines, the statuses answered and the
    sink's connections."""
    raw = _copy(raw)
    s = raw["streams"][0]
    srv, sink = FakeRedisServer(), HttpSink(statuses=statuses, status=204)
    await srv.start()
    await sink.start()
    try:
        keys = s["input"]["keys"]
        s["input"]["url"] = f"redis://127.0.0.1:{srv.port}"
        s["output"]["url"] = f"http://127.0.0.1:{sink.port}"
        half = len(values) // 2
        for i, v in enumerate(values):
            srv.push((keys[0] if i < half else keys[-1]).encode(), v)
        engine, stream = _build(raw, prepare)
        wall = await run_until(engine, lambda: len(sink_lines(sink)) >= len(values),
                               timeout_s=timeout_s)
        return {**_stream_report(stream, wall), "lines": sink_lines(sink),
                "answered": list(sink.answered), "bodies": [r[3] for r in sink.requests],
                "targets": sorted({r[1] for r in sink.requests}),
                "authorization": sorted({r[2].get("authorization", "") for r in sink.requests}),
                "connections": sink.connections, "left_in_lists": sum(
                    len(srv.lists.get(k.encode(), [])) for k in keys)}
    finally:
        await srv.stop()
        await sink.stop()


async def ws_redis_to_http(raw: dict, ws_values: list[str], redis_values: list[bytes],
                           prepare: Prepare = None, timeout_s: float = 120.0) -> dict:
    """``ws_redis_bert_http.json``: a websocket server sending
    ``ws_values`` (text) on connect and ``redis_values`` published on the
    subscribe child's first channel once it subscribed; the stream stops once
    the HTTP sink took one row a value. The rows (each a line of a request
    body) and every request's headers."""
    raw = _copy(raw)
    s = raw["streams"][0]
    ws, srv, sink = FakeWebsocketServer(ws_values), FakeRedisServer(), HttpSink()
    for fake in (ws, srv, sink):
        await fake.start()
    pub = RedisClient(f"redis://127.0.0.1:{srv.port}")
    try:
        channel = None
        for child in s["input"]["inputs"]:
            if child["type"] == "websocket":
                child["url"] = f"ws://127.0.0.1:{ws.port}/feed"
            elif child["type"] == "redis":
                child["url"] = f"redis://127.0.0.1:{srv.port}"
                channel = child["channels"][0]
        s["output"]["url"] = f"http://127.0.0.1:{sink.port}/classified"
        engine, stream = _build(raw, prepare)
        total = len(ws_values) + len(redis_values)

        async def feed() -> None:
            while not srv.subscribers:
                await asyncio.sleep(0.005)
            await pub.connect()
            for v in redis_values:
                await pub.publish(channel, v)

        wall = await run_until(engine, lambda: len(sink_lines(sink)) >= total, feed, timeout_s)
        return {**_stream_report(stream, wall), "rows": sink_lines(sink),
                "headers": [r[2] for r in sink.requests], "answered": list(sink.answered),
                "requests": len(sink.requests), "connections": sink.connections,
                "ws_handshakes": ws.handshakes, "redis_published": srv.published}
    finally:
        await pub.close()
        for fake in (ws, srv, sink):
            await fake.stop()


async def modbus_to_influx(raw: dict, polls: int, prepare: Prepare = None,
                           timeout_s: float = 120.0) -> dict:
    """``modbus_influx.json``: a Modbus server whose values change with
    every request; the stream stops once the InfluxDB sink took ``polls``
    lines. The lines and every request the server served, in order."""
    raw = _copy(raw)
    s = raw["streams"][0]
    srv, sink = FakeModbusServer(), HttpSink(status=204)
    await srv.start()
    await sink.start()
    try:
        s["input"].update(host="127.0.0.1", port=srv.port)
        s["output"]["url"] = f"http://127.0.0.1:{sink.port}"
        engine, stream = _build(raw, prepare)
        wall = await run_until(engine, lambda: len(sink_lines(sink)) >= polls,
                               timeout_s=timeout_s)
        return {**_stream_report(stream, wall), "lines": sink_lines(sink),
                "served": list(srv.served), "answered": list(sink.answered)}
    finally:
        await srv.stop()
        await sink.stop()


async def run_to_end(engine: Engine, stream, timeout_s: float = 120.0) -> float:
    """Run ``engine`` until its finite input ends and the stream drained;
    the wall seconds. A stream that reported errors raises."""
    t0 = time.perf_counter()
    await asyncio.wait_for(engine.run(), timeout_s)
    wall = time.perf_counter() - t0
    if stream.errors:
        raise StreamFailed(f"the stream reported errors: {stream.errors}")
    return wall


async def file_to_pulsar(raw: dict, paths: list[str], prepare: Prepare = None,
                         timeout_s: float = 120.0) -> dict:
    """``file_bert_pulsar.json``: the file input over ``paths``, the pulsar
    output on a ``FakePulsarBroker``; the stream runs to the end of its
    files. Returns the output topic's payloads in arrival order and the
    producers that sent them."""
    raw = _copy(raw)
    s = raw["streams"][0]
    broker = FakePulsarBroker()
    await broker.start()
    try:
        s["input"]["path"] = list(paths)
        s["output"]["service_url"] = f"pulsar://127.0.0.1:{broker.port}"
        engine, stream = _build(raw, prepare)
        wall = await run_to_end(engine, stream, timeout_s)
        topic = validate_topic(s["output"]["topic"])
        return {**_stream_report(stream, wall),
                "payloads": [p for p, _ in broker.topics.get(topic, [])],
                "entries": len(broker.logs.get(topic, []))}
    finally:
        await broker.stop()


async def pulsar_to_pulsar(raw: dict, values: list[bytes], prepare: Prepare = None,
                           timeout_s: float = 120.0) -> dict:
    """``pulsar_example.json``: ``values`` stored in the input topic before
    the run; the stream stops once its subscription acked every one (each
    message is its own batch, acked after its write). Returns the output
    topic's payloads in order, the acks and the redeliveries."""
    raw = _copy(raw)
    s = raw["streams"][0]
    inp = s["input"]
    broker = FakePulsarBroker()
    await broker.start()
    try:
        inp["service_url"] = s["output"]["service_url"] = f"pulsar://127.0.0.1:{broker.port}"
        in_topic = validate_topic(inp["topic"])
        for v in values:
            broker.append(in_topic, [v])
        engine, stream = _build(raw, prepare)
        sub = inp["subscription_name"]
        wall = await run_until(engine, lambda: broker.unacked(in_topic, sub) == 0,
                               timeout_s=timeout_s)
        await asyncio.sleep(0.05)  # a late duplicate would land by now
        out_topic = validate_topic(s["output"]["topic"])
        return {**_stream_report(stream, wall),
                "payloads": [p for p, _ in broker.topics.get(out_topic, [])],
                "acked": len(broker.acked), "unacked": broker.unacked(in_topic, sub),
                "redelivered": broker.redelivered}
    finally:
        await broker.stop()


async def file_to_stdout(raw: dict, path: str, prepare: Prepare = None,
                         timeout_s: float = 120.0) -> dict:
    """``avro_file_example.json``: the file input over ``path`` (its
    ``format`` by extension), run to the end; returns the stdout lines."""
    raw = _copy(raw)
    raw["streams"][0]["input"]["path"] = path
    engine, stream = _build(raw, prepare)
    lines: list[bytes] = []
    stream.output._write = lines.append
    wall = await run_to_end(engine, stream, timeout_s)
    return {**_stream_report(stream, wall), "lines": lines}
