"""The ``{expr: ...}`` config values on the outputs that read one per row,
against the JAX package's, on the JAX tests' fakes and the port's own
(``tools/fake_brokers.py``): the Kafka output's per-row ``key`` (BASELINE
config 2's ``json_get_str(__value__, 'label')``) and ``topic``, with each
record's partition, and the NATS output's per-row ``subject``. Then the two BASELINE examples whose left-out steps this slice
restores, held to their YAML."""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest
import yaml

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, build_component, ensure_plugins_loaded
from arkflow_tpu_torch.connect.kafka_client import partition_for_key
from arkflow_tpu_torch.connect.nats_client import NatsClient
from tests.test_connectors import FakeNatsServer
from tests.test_torch_kafka import _RecordingBroker, run, stop

jax_plugins()
ensure_plugins_loaded()

LABELS = ["pos", "neg", "neu"]


def _scored_rows(seed: int, n: int) -> list[bytes]:
    """``arrow_to_json`` rows of a classifier: id, label, score."""
    rng = np.random.default_rng(seed)
    return [json.dumps({"id": int(i), "label": LABELS[int(rng.integers(0, 3))],
                        "score": round(float(rng.random()), 4)}).encode()
            for i in range(n)]


@pytest.mark.parametrize("extra", [
    {"key": {"expr": "json_get_str(__value__, 'label')"}},
    {"key": {"expr": "json_get_str(__value__, 'label')"}, "partitioner": "crc32c",
     "compression": "gzip"},
    {"topic": {"expr": "concat('T-', json_get_str(__value__, 'label'))"}},
], ids=["label_key", "label_key_crc32c", "label_topic"])
def test_kafka_output_per_row_values_match_jax(extra):
    """Each package's output writes the same batches (with metadata, as a
    stream's would) to its own topics on one JAX fake broker: the records,
    their keys and their partitions are equal, and every keyed record sits
    on the partition its key hashes to."""
    per_topic = "topic" in extra

    async def go():
        topics = ({f"{p}-{lbl}": 4 for p in ("J", "P") for lbl in LABELS} if per_topic
                  else {"oj": 4, "op": 4})
        broker = _RecordingBroker(topics)
        await broker.start()
        brokers = f"127.0.0.1:{broker.port}"
        try:
            batches = [_scored_rows(s, n) for s, n in ((1, 7), (2, 1), (3, 12))]
            for side, jax in (("J", True), ("P", False)):
                cfg = {"type": "kafka", "brokers": brokers,
                       "topic": "oj" if jax else "op", **extra}
                if per_topic:
                    cfg["topic"] = {"expr": extra["topic"]["expr"].replace("'T-'", f"'{side}-'")}
                out = (jax_build("output", cfg, JaxResource()) if jax
                       else build_component("output", cfg, Resource()))
                await out.connect()
                for payloads in batches:
                    b = (JaxBatch.new_binary(payloads) if jax
                         else MessageBatch.new_binary(payloads)).with_source("kafka:text-events")
                    await out.write(b)
                await out.close()
            if per_topic:
                for lbl in LABELS:
                    jrec = [(p, c, r) for t, p, c, r in broker.produced if t == f"J-{lbl}"]
                    prec = [(p, c, r) for t, p, c, r in broker.produced if t == f"P-{lbl}"]
                    assert prec == jrec and prec
                    assert all(json.loads(v)["label"] == lbl for _, _, r in prec for _, v in r)
                return
            jp = [(p, c, r) for t, p, c, r in broker.produced if t == "oj"]
            pp = [(p, c, r) for t, p, c, r in broker.produced if t == "op"]
            assert pp == jp and pp
            n = 0
            for part, _, records in pp:
                for key, value in records:
                    assert key.decode() == json.loads(value)["label"]
                    if extra.get("partitioner") != "crc32c":
                        assert partition_for_key(key, 4) == part
                    n += 1
            assert n == 20
        finally:
            stop(broker)

    run(go())


def test_nats_output_per_row_subjects_match_jax():
    """``subject: {expr: ...}``: one subject a row (json codec, a payload a
    row), the same payloads on each subject as JAX's output sends."""
    async def go():
        srv = FakeNatsServer()
        await srv.start()
        try:
            url = f"nats://127.0.0.1:{srv.port}"
            cities = ["sf", "la", "ny"]
            seen: dict = {f"{p}.{c}": [] for p in ("oj", "op") for c in cities}
            sub = NatsClient(url)
            await sub.connect()
            for s in seen:
                await sub.subscribe(s, lambda m: seen[m.subject].append(m.payload))
            data = {"city": ["sf", "la", "sf", "ny", "la"], "v": [1, 2, 3, 4, 5]}
            for prefix, jax in (("oj", True), ("op", False)):
                cfg = {"type": "nats", "url": url, "codec": "json",
                       "subject": {"expr": f"concat('{prefix}.', city)"}}
                out = (jax_build("output", cfg, JaxResource()) if jax
                       else build_component("output", cfg, Resource()))
                await out.connect()
                await out.write((JaxBatch if jax else MessageBatch).from_pydict(data))
                await out.close()
            for _ in range(50):
                if sum(len(v) for v in seen.values()) >= 10:
                    break
                await asyncio.sleep(0.01)
            await sub.close()
            for c in cities:
                assert seen[f"op.{c}"] == seen[f"oj.{c}"] and seen[f"op.{c}"]
                assert all(json.loads(p)["city"] == c for p in seen[f"op.{c}"])
        finally:
            srv.server.close()

    run(go())


def test_per_row_keys_and_subjects_on_the_ports_fakes_match_jax():
    """The same per-row Kafka keys and NATS subjects through the port's own
    fakes (``tools/fake_brokers.py``): each package's output, the same
    records, keys and partitions, the same payloads on each subject."""
    from arkflow_tpu_torch.tools.fake_brokers import FakeKafkaBroker as PortKafka
    from arkflow_tpu_torch.tools.fake_brokers import FakeNatsServer as PortNats

    async def go():
        kafka, nats = PortKafka({"oj": 4, "op": 4}), PortNats()
        await kafka.start()
        await nats.start()
        try:
            url = f"nats://127.0.0.1:{nats.port}"
            sub = NatsClient(url)
            await sub.connect()
            seen: dict = {}
            for side in ("oj", "op"):
                await sub.subscribe(f"{side}.>", lambda m: seen.setdefault(
                    m.subject, []).append(m.payload))
            rows = _scored_rows(7, 12)
            for side, jax in (("oj", True), ("op", False)):
                build = ((lambda c: jax_build("output", c, JaxResource())) if jax
                         else (lambda c: build_component("output", c, Resource())))
                batch = (JaxBatch if jax else MessageBatch).new_binary(rows)
                for cfg in ({"type": "kafka", "brokers": f"127.0.0.1:{kafka.port}",
                             "topic": side,
                             "key": {"expr": "json_get_str(__value__, 'label')"}},
                            {"type": "nats", "url": url,
                             "subject": {"expr": f"concat('{side}.', "
                                                 f"json_get_str(__value__, 'label'))"}}):
                    out = build(cfg)
                    await out.connect()
                    await out.write(batch)
                    await out.close()
            for _ in range(50):
                if sum(len(v) for v in seen.values()) >= 24:
                    break
                await asyncio.sleep(0.01)
            await sub.close()
            for p in range(4):
                jrec = [(r.key, r.value) for r in kafka.records("oj", p)]
                prec = [(r.key, r.value) for r in kafka.records("op", p)]
                assert prec == jrec
                assert all(k == json.loads(v)["label"].encode() for k, v in prec)
            assert sum(len(kafka.records("op", p)) for p in range(4)) == 12
            assert sum(len(v) for v in seen.values()) == 24
            for lbl in LABELS:
                assert seen.get(f"op.{lbl}") == seen.get(f"oj.{lbl}")
        finally:
            await kafka.stop()
            await nats.stop()

    run(go())


@pytest.mark.parametrize("name,yaml_name,step", [
    ("kafka_bert_kafka", "kafka_bert_kafka", ("output", "key")),
    ("mqtt_lstm_anomaly", "mqtt_lstm_anomaly", ("processor", "remap")),
], ids=["config2_key", "config3_remap"])
def test_restored_steps_are_the_yamls(name, yaml_name, step):
    """BASELINE configs 2 and 3 on the port carry the steps the JAX
    examples write: config 2's output key expression, config 3's remap."""
    with open(f"arkflow_tpu_torch/examples/{name}.json") as f:
        port = json.load(f)["streams"][0]
    with open(f"examples/{yaml_name}.yaml") as f:
        src = yaml.safe_load(f)["streams"][0]
    if step[0] == "output":
        assert port["output"][step[1]] == src["output"][step[1]]
    else:
        want = [p for p in src["pipeline"]["processors"] if p["type"] == step[1]]
        got = [p for p in port["pipeline"]["processors"] if p["type"] == step[1]]
        assert got == want and len(got) == 1
