"""The four broker examples on the port against the JAX package's streams.

Each port example (``arkflow_tpu_torch/examples/{kafka_bert_kafka,
mqtt_lstm_anomaly,http_vit_redis,cdc_llm_nats}.json``) runs at a tiny width
on ``device: cpu`` beside the JAX stream of the YAML of the same name
(``examples/*.yaml``, with ``tpu_inference``/``tpu_generate`` at the same
tiny width; the MQTT stream without its ``remap``, so that every row's
score is compared, the remap then held on those rows), both on the JAX
stream's weights, through fake brokers, and
their output topic, stdout lines, Redis list or NATS subject are compared:
ids and keys exactly, bf16 BERT scores within 1/64 with labels exact on
tie-free rows, LSTM scores within 1e-5, ViT embeddings within 1/64 of their
largest magnitude, greedy tokens up to each row's first near-tie (a
step whose top-2 logit gap on the port is at most ``TIE_MARGIN``).
"""

from __future__ import annotations

import asyncio
import json
import math
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.config import StreamConfig as JaxStreamConfig
from arkflow_tpu.runtime import build_stream as jax_build_stream
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, build_component, ensure_plugins_loaded
from arkflow_tpu_torch.config import EngineConfig
from arkflow_tpu_torch.connect import kafka_client as pk
from arkflow_tpu_torch.connect.kafka_client import partition_for_key
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.models import decoder as dec
from arkflow_tpu_torch.runtime.engine import Engine
from arkflow_tpu_torch.tools.fake_brokers import FakeMqttBroker
from arkflow_tpu_torch.tpu import checkpoint
from arkflow_tpu_torch.tpu.runner import ModelRunner
from tests.test_connectors import FakeNatsServer, FakeRedisServer
from tests.test_kafka import FakeKafkaBroker
from tests.test_torch_tensor_stream import TINY_LSTM, TINY_VIT
from tests.test_tpu_layer import TINY_BERT

jax_plugins()
ensure_plugins_loaded()

ROOT = Path(__file__).resolve().parent.parent
SCORE_TOL = 1.0 / 64
F32_TOL = 1e-5
TIE_FREE_SCORE = 1.0 / (1.0 + math.exp(-0.05))
#: a greedy step whose top-2 logit gap is at or below this is a near-tie
TIE_MARGIN = 0.05
TINY_DECODER = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, ffn=96, max_seq=64)


def configs(name: str) -> tuple[dict, dict]:
    """(the JAX stream config from the YAML, the port engine config)."""
    with open(ROOT / "examples" / f"{name}.yaml") as f:
        jax_raw = yaml.safe_load(f)["streams"][0]
    with open(ROOT / "arkflow_tpu_torch" / "examples" / f"{name}.json") as f:
        port_raw = json.load(f)
    port_raw["health_check"] = {"enabled": False}
    return jax_raw, port_raw


async def drive(stream, done, feed=None, timeout_s: float = 20.0) -> None:
    """Run ``stream`` until ``done()``; ``feed`` runs once its input is
    connected (``stream.connected()``)."""
    cancel = asyncio.Event()
    task = asyncio.create_task(stream.run(cancel))
    end = time.monotonic() + timeout_s
    if feed is not None:
        await feed()
    while not done():
        assert not task.done(), "the stream ended before its output was complete"
        assert time.monotonic() < end, "the stream's output did not complete in time"
        await asyncio.sleep(0.02)
    cancel.set()
    await asyncio.wait_for(task, timeout_s)


def run(coro, timeout: float = 60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def stop(*fakes) -> None:
    for fake in fakes:
        fake.server.close()


def port_stream(port_raw: dict):
    engine = Engine(EngineConfig.from_mapping(port_raw))
    return engine.build()[0]


def swap_runner(stream, index: int, model: str, mc: dict, host) -> None:
    proc = stream.pipeline.processors[index]
    proc.runner = ModelRunner(model, mc, buckets=proc.runner.buckets, device="cpu",
                              host_params=params_from_jax(host))


def test_kafka_bert_kafka_matches_the_jax_stream():
    jax_raw, port_raw = configs("kafka_bert_kafka")
    rng = np.random.default_rng(11)
    vocab = [f"w{i}" for i in range(60)]
    texts = [f"msg{i} " + " ".join(rng.choice(vocab, size=int(n)))
             for i, n in enumerate(rng.integers(1, 24, 40))]
    proc_keys = dict(model_config=TINY_BERT, max_seq=32, batch_buckets=[4, 8],
                     seq_buckets=[16, 32], warmup=False)

    async def go():
        broker = FakeKafkaBroker({"text-events": 4, "scores-jax": 4, "scores-port": 4})
        broker.JOIN_WINDOW_S = 0.05
        await broker.start()
        brokers = f"127.0.0.1:{broker.port}"
        try:
            prod = pk.KafkaClient(brokers)
            await prod.connect()
            await prod.refresh_metadata(["text-events"])
            for p, codec in enumerate(("gzip", "snappy", "lz4", None)):
                await prod.produce("text-events", p, [(None, t.encode()) for t in texts[p::4]],
                                   compression=codec)
            await prod.close()
            out = {}
            for kind in ("jax", "port"):
                raw = jax_raw if kind == "jax" else port_raw["streams"][0]
                raw = json.loads(json.dumps(raw))
                raw["input"].update(brokers=brokers, group=f"g-{kind}", batch_size=8)
                raw["buffer"].update(capacity=8)
                raw["output"].update(brokers=brokers, topic=f"scores-{kind}")
                raw["pipeline"]["processors"][0].update(proc_keys)
                if kind == "jax":
                    stream = jax_build_stream(JaxStreamConfig.from_mapping(raw))
                    host = jax.device_get(stream.pipeline.processors[0].runner.host_params)
                else:
                    raw["pipeline"]["processors"][0]["device"] = "cpu"
                    stream = port_stream({**port_raw, "streams": [raw]})
                    swap_runner(stream, 0, "bert_classifier", TINY_BERT, host)
                group = f"g-{kind}"

                def done(kind=kind, group=group):
                    n = sum(len(broker.logs[(f"scores-{kind}", p)]) for p in range(4))
                    committed = [broker.group_offsets.get((group, "text-events", p))
                                 for p in range(4)]
                    return n >= len(texts) and committed == [10] * 4

                await drive(stream, done)
                out[kind] = [(p, k, json.loads(v)) for p in range(4)
                             for k, v, _ in broker.logs[(f"scores-{kind}", p)]]
                assert stream.errors == 0 if kind == "port" else True
            return out
        finally:
            stop(broker)

    out = run(go())
    by_text = {kind: {r["__value__"]: (p, k, r) for p, k, r in rows} for kind, rows in out.items()}
    assert sorted(by_text["port"]) == sorted(by_text["jax"]) == sorted(texts)
    assert len(out["port"]) == len(texts)  # each record exactly once
    for text in texts:
        (_, pk_, pr), (_, jk_, jr) = by_text["port"][text], by_text["jax"][text]
        # config 2's key: each record keyed by its own label, on the
        # partition the key hashes to
        assert pk_ == str(pr["label"]).encode() and jk_ == str(jr["label"]).encode()
        assert by_text["port"][text][0] == partition_for_key(pk_, 4)
        assert list(pr) == list(jr) == ["__value__", "label", "score"]
        assert abs(pr["score"] - jr["score"]) <= SCORE_TOL
        if jr["score"] > TIE_FREE_SCORE:
            assert pr["label"] == jr["label"]


def test_mqtt_lstm_anomaly_matches_the_jax_stream():
    jax_raw, port_raw = configs("mqtt_lstm_anomaly")
    rng = np.random.default_rng(12)
    window = TINY_LSTM["window"] * TINY_LSTM["features"]
    rows = rng.random((24, window)).astype(np.float32)
    rows[5] *= 30.0
    messages = [json.dumps({"window": r.tolist()}).encode() for r in rows]

    async def go():
        out = {}
        host = None
        for kind in ("jax", "port"):
            broker = FakeMqttBroker()
            await broker.start()
            try:
                raw = jax_raw if kind == "jax" else port_raw["streams"][0]
                raw = json.loads(json.dumps(raw))
                raw["input"].update(host="127.0.0.1", port=broker.port)
                procs = [p for p in raw["pipeline"]["processors"] if p["type"] != "remap"]
                procs[0].update(model_config=TINY_LSTM, batch_buckets=[4, 8])
                raw["pipeline"]["processors"] = procs
                lines: list = []
                if kind == "jax":
                    stream = jax_build_stream(JaxStreamConfig.from_mapping(raw))
                    host = jax.device_get(stream.pipeline.processors[0].runner.host_params)
                else:
                    procs[0]["device"] = "cpu"
                    stream = port_stream({**port_raw, "streams": [raw]})
                    swap_runner(stream, 0, "lstm_ae", TINY_LSTM, host)
                stream.output._write = lines.append

                async def feed():
                    while not broker.subs:
                        await asyncio.sleep(0.01)
                    from arkflow_tpu_torch.connect.mqtt_client import MqttClient
                    pub = MqttClient("127.0.0.1", broker.port, client_id=f"pub-{kind}")
                    await pub.connect()
                    for i, m in enumerate(messages):
                        await pub.publish(f"sensors/dev{i % 3}", m, qos=1)
                    await pub.close()

                await drive(stream, lambda: len(lines) >= len(messages), feed)
                out[kind] = [json.loads(x) for x in lines]
            finally:
                stop(broker)
        return out

    out = run(go())
    assert len(out["port"]) == len(out["jax"]) == len(messages)
    assert [list(r) for r in out["port"]] == [list(r) for r in out["jax"]]
    assert [r["window"] for r in out["port"]] == [r["window"] for r in out["jax"]]
    np.testing.assert_allclose([r["score"] for r in out["port"]],
                               [r["score"] for r in out["jax"]], atol=F32_TOL, rtol=F32_TOL)
    assert int(np.argmax([r["score"] for r in out["port"]])) == 5
    # config 3's remap on the port's scores, in each package: the same
    # anomalies with the same alert texts
    remap = next(p for p in jax_raw["pipeline"]["processors"] if p["type"] == "remap")
    scores = {"score": [r["score"] for r in out["port"]]}
    jrem = asyncio.run(jax_build("processor", remap, JaxResource()).process(
        JaxBatch.from_pydict(scores)))
    prem = asyncio.run(build_component("processor", remap, Resource()).process(
        MessageBatch.from_pydict(scores)))
    assert [b.to_pydict() for b in prem] == [b.to_pydict() for b in jrem]
    assert prem and prem[0].to_pydict()["score"] == [x for x in scores["score"] if x > 0.5]


async def _post_all(port: int, bodies: list) -> list:
    """POST every body on one keep-alive connection; the statuses."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    statuses = []
    try:
        for body in bodies:
            writer.write(b"POST /images HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n"
                         % len(body) + body)
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            lines = head.decode().split("\r\n")
            n = int(next(v for k, _, v in (x.partition(":") for x in lines[1:])
                         if k.lower() == "content-length"))
            await reader.readexactly(n)
            statuses.append(int(lines[0].split()[1]))
    finally:
        writer.close()
    return statuses


def test_http_vit_redis_matches_the_jax_stream():
    jax_raw, port_raw = configs("http_vit_redis")
    size = TINY_VIT["image_size"] ** 2 * 3
    images = np.random.default_rng(13).integers(0, 256, (20, size), dtype=np.uint8)
    bodies = [images[i].tobytes() for i in range(len(images))]

    async def go():
        srv = FakeRedisServer()
        await srv.start()
        out, statuses = {}, {}
        host = None
        try:
            for kind in ("jax", "port"):
                raw = jax_raw if kind == "jax" else port_raw["streams"][0]
                raw = json.loads(json.dumps(raw))
                raw["input"].update(host="127.0.0.1", port=0,
                                    rate_limit={"capacity": 20, "per_second": 0.01})
                raw["pipeline"]["processors"][0].update(model_config=TINY_VIT,
                                                        batch_buckets=[4, 8])
                raw["output"].update(url=f"redis://127.0.0.1:{srv.port}",
                                     target=f"emb-{kind}")
                if kind == "jax":
                    stream = jax_build_stream(JaxStreamConfig.from_mapping(raw))
                    host = jax.device_get(stream.pipeline.processors[0].runner.host_params)
                else:
                    raw["pipeline"]["processors"][0]["device"] = "cpu"
                    stream = port_stream({**port_raw, "streams": [raw]})
                    swap_runner(stream, 0, "vit_embedder", TINY_VIT, host)
                inp = stream.input

                async def feed(kind=kind, inp=inp):
                    while True:
                        bound = (getattr(inp, "_runner", None) and inp._runner.addresses
                                 if kind == "jax" else inp._server is not None)
                        if bound:
                            break
                        await asyncio.sleep(0.01)
                    port = inp._runner.addresses[0][1] if kind == "jax" else inp.port
                    statuses[kind] = await _post_all(port, bodies + [bodies[0]])

                key = f"emb-{kind}".encode()
                await drive(stream, lambda key=key: len(srv.lists.get(key, [])) >= len(bodies),
                            feed)
                out[kind] = [json.loads(x)["embedding"] for x in srv.lists[key]]
        finally:
            stop(srv)
        return out, statuses

    out, statuses = run(go())
    assert statuses["port"] == statuses["jax"] == [200] * 20 + [429]  # capacity 20
    got, want = np.array(out["port"]), np.array(out["jax"])
    assert got.shape == want.shape == (20, TINY_VIT["hidden"])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= SCORE_TOL * scale


def test_cdc_llm_nats_matches_the_jax_stream(tmp_path, monkeypatch):
    jax_raw, port_raw = configs("cdc_llm_nats")
    prompts = [f"row {i} changed: " + " ".join(f"c{(i * 7 + j) % 40}" for j in range(i % 9))
               for i in range(10)]
    gen_keys = dict(model_config=TINY_DECODER, max_input=16, max_new_tokens=5,
                    batch_buckets=[4, 16], seq_buckets=[8, 16])

    async def go():
        broker = FakeKafkaBroker({"cdc-events": 1})
        broker.JOIN_WINDOW_S = 0.05
        nats = FakeNatsServer()
        await broker.start()
        await nats.start()
        brokers = f"127.0.0.1:{broker.port}"
        try:
            prod = pk.KafkaClient(brokers)
            await prod.connect()
            await prod.refresh_metadata(["cdc-events"])
            await prod.produce("cdc-events", 0, [(None, p.encode()) for p in prompts])
            await prod.close()
            from arkflow_tpu_torch.connect.nats_client import NatsClient
            sub = NatsClient(f"nats://127.0.0.1:{nats.port}")
            await sub.connect()
            seen: dict = {"cdc.jax": [], "cdc.port": []}
            for s in seen:
                await sub.subscribe(s, lambda m: seen[m.subject].append(m.payload))
            for kind in ("jax", "port"):
                raw = jax_raw if kind == "jax" else port_raw["streams"][0]
                raw = json.loads(json.dumps(raw))
                raw["input"].update(brokers=brokers, group=f"g-{kind}")
                raw["output"].update(url=f"nats://127.0.0.1:{nats.port}",
                                     subject=f"cdc.{kind}")
                raw["pipeline"]["processors"][0].update(gen_keys)
                if kind == "jax":
                    stream = jax_build_stream(JaxStreamConfig.from_mapping(raw))
                    params = jax.device_get(stream.pipeline.processors[0].params)
                    ck = str(tmp_path / "decoder")
                    checkpoint.save(ck, params_from_jax(params))
                else:
                    raw["pipeline"]["processors"][0].update(device="cpu", checkpoint=ck)
                    raw["pipeline"]["processors"][0].pop("seed", None)
                    stream = port_stream({**port_raw, "streams": [raw]})
                await drive(stream, lambda k=kind: len(seen[f"cdc.{k}"]) >= len(prompts))
            await sub.close()
            return seen
        finally:
            stop(broker, nats)

    generations: list = []  # per port generation: (real rows, [gaps a step])
    start, select = dec.start_generation, dec.select_token

    def recording_start(params, cfg, input_ids, lengths, n_real, *a, **kw):
        warm = bool((input_ids == 1).all() and (lengths == 1).all())  # the connect warmup
        generations.append((0 if warm else int(n_real.reshape(())), []))
        return start(params, cfg, input_ids, lengths, n_real, *a, **kw)

    def recording_select(logits, *a, **kw):
        top2 = logits.float().topk(2, dim=-1).values
        generations[-1][1].append((top2[:, 0] - top2[:, 1]).tolist())
        return select(logits, *a, **kw)

    monkeypatch.setattr(dec, "start_generation", recording_start)
    monkeypatch.setattr(dec, "select_token", recording_select)
    seen = run(go())
    got = [json.loads(x) for x in seen["cdc.port"]]
    want = [json.loads(x) for x in seen["cdc.jax"]]
    assert [list(r) for r in got] == [list(r) for r in want] == [["summary"]] * len(prompts)
    gaps = [[step[r] for step in steps] for n, steps in generations for r in range(n)]
    assert len(gaps) == len(prompts)
    compared = 0
    for g, w, row_gaps in zip(got, want, gaps):
        a, b = g["summary"].split(), w["summary"].split()
        k = next((j for j, gap in enumerate(row_gaps) if gap <= TIE_MARGIN), len(row_gaps))
        assert a[:k] == b[:k], (a, b, row_gaps)
        compared += min(k, len(a))
    assert compared >= 2 * len(prompts)  # tokens held, before the first near-tie


@pytest.mark.parametrize("name", ["kafka_bert_kafka", "mqtt_lstm_anomaly", "http_vit_redis",
                                  "cdc_llm_nats"])
def test_broker_examples_validate_and_mirror_their_yaml(name, capsys):
    """Each example passes ``--validate``, names its YAML, and keeps the
    YAML's stream name, input, buffer and output keys (the SQL ``key``
    included) and its ``remap``."""
    from arkflow_tpu_torch.runtime import cli

    path = ROOT / "arkflow_tpu_torch" / "examples" / f"{name}.json"
    assert cli.main(["--config", str(path), "--validate"]) == 0
    assert "config OK" in capsys.readouterr().out
    jax_raw, port_raw = configs(name)
    port = port_raw["streams"][0]
    assert f"examples/{name}.yaml" in port_raw["description"]
    assert port["name"] == jax_raw["name"]
    assert port["input"] == jax_raw["input"] and port["buffer"] == jax_raw["buffer"]
    assert port["output"] == jax_raw["output"]
    assert ([p for p in port["pipeline"]["processors"] if p["type"] == "remap"]
            == [p for p in jax_raw["pipeline"]["processors"] if p["type"] == "remap"])
