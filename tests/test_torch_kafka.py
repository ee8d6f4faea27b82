"""The port's Kafka client, input and output against the JAX package's.

Record batches byte for byte (CRC included) for every codec the two
packages share, each package decoding the other's bytes; ``murmur2``,
``partition_for_key`` and both assignors on the same inputs (member sets
drawn by ``hypothesis``); the Kafka input's batches and committed offsets
and the output's keys, partitions, values and codecs through the JAX
package's ``FakeKafkaBroker``, whose codec is JAX's, so a fault in the
port's codec cannot hide behind a fake that shares it; the SASL PLAIN
handshake; the cooperative rebalance that keeps its positions; and the
configs the port refuses.
"""

from __future__ import annotations

import asyncio
import gzip
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import arkflow_tpu.connect.kafka_client as jk
import arkflow_tpu.native as jax_native
from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, build_component, check_component
from arkflow_tpu_torch.components import ensure_plugins_loaded
from arkflow_tpu_torch.connect import kafka_client as pk
from arkflow_tpu_torch.errors import ConfigError, ConnectError
from arkflow_tpu_torch.native import crc32c
from arkflow_tpu_torch.plugins.input import kafka as port_kafka_in
from tests.test_kafka import FakeKafkaBroker

jax_plugins()
ensure_plugins_loaded()

CODECS = [None, "gzip", "snappy", "lz4", "zstd"]


def run(coro, timeout: float = 20.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def stop(fake) -> None:
    """Stop a JAX fake's listener without its ``stop``'s bounded wait (an
    idle peer transport holds ``wait_closed`` for its full second)."""
    fake.server.close()


def _records(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = None if i % 5 == 0 else rng.bytes(int(rng.integers(0, 12)))
        value = None if i % 11 == 3 else rng.bytes(int(rng.integers(0, 300)))
        out.append((key, value))
    return out


@pytest.fixture
def jax_python_tier(monkeypatch):
    """The JAX package on its pure-Python codec tier, the port's only one."""
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", True)
    monkeypatch.setattr(gzip.time, "time", lambda: 1700000000.0)  # gzip's header mtime


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: c or "none")
def test_record_batch_bytes_match_jax(codec, jax_python_tier):
    records = _records(1)
    want = jk.encode_record_batch(records, base_ts_ms=1234567, compression=codec)
    got = pk.encode_record_batch(records, base_ts_ms=1234567, compression=codec)
    assert got == want
    # the CRC at bytes 17..21 covers attributes..records, Castagnoli
    assert struct.unpack(">I", got[17:21])[0] == crc32c(got[21:])
    assert crc32c(got[21:]) == jax_native._py_crc32c(got[21:])


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: c or "none")
def test_record_batches_cross_decode(codec):
    """Each package decodes the other's bytes; the JAX side on its native
    tier here, so its snappy and lz4 blocks carry real copies."""
    records = _records(2, n=64)
    records += [(b"k", b"abc" * 500)] * 3  # compressible: the native tier copies
    jbytes = jk.encode_record_batch(records, base_ts_ms=77, compression=codec)
    pbytes = pk.encode_record_batch(records, base_ts_ms=77, compression=codec)
    for data in (jbytes, pbytes):
        for decode in (jk.decode_record_set, pk.decode_record_set):
            recs, next_offset = decode(data)
            assert [(r.key, r.value) for r in recs] == records
            assert [r.offset for r in recs] == list(range(len(records)))
            assert {r.timestamp_ms for r in recs} == {77}
            assert next_offset == len(records)


def test_record_set_of_several_batches_and_control_batches():
    a = pk.encode_record_batch([(None, b"a"), (None, b"b")], base_ts_ms=5)
    b = pk.encode_record_batch([(b"k", b"c")], base_ts_ms=6, compression="lz4")
    b = struct.pack(">q", 2) + b[8:]
    ctrl = bytearray(pk.encode_record_batch([(None, b"marker")], base_ts_ms=7))
    ctrl[0:8] = struct.pack(">q", 3)
    ctrl[22] |= 0x20  # control batch
    blob = a + b + bytes(ctrl)
    for decode in (jk.decode_record_set, pk.decode_record_set):
        recs, nxt = decode(blob)
        assert [(r.offset, r.value) for r in recs] == [(0, b"a"), (1, b"b"), (2, b"c")]
        assert nxt == 4


def test_xcodecs_match_jax_python_tier():
    import arkflow_tpu.utils.xcodecs as jx
    import arkflow_tpu_torch.utils.xcodecs as px

    rng = np.random.default_rng(3)
    for n in (0, 1, 15, 16, 17, 100, 70000):
        data = rng.bytes(n)
        assert px.xxh32(data, 0) == jx._py_xxh32(data, 0)
        assert px.xxh32(data, 7) == jx._py_xxh32(data, 7)
        assert px.snappy_block_compress(data) == jx._py_snappy_compress(data)
        assert px.snappy_decode(jx.snappy_encode(data)) == data  # JAX native copies
        assert px.lz4_frame_decode(jx.lz4_frame_encode(data)) == data
        assert jx.lz4_frame_decode(px.lz4_frame_encode(data)) == data
        assert jx.snappy_decode(px.snappy_encode(data)) == data
    raw = jx.snappy_block_compress(b"abcd" * 100)  # a raw (non-xerial) block
    assert px.snappy_decode(raw) == b"abcd" * 100


def test_murmur2_and_partition_for_key_match_jax():
    rng = np.random.default_rng(4)
    keys = [b"", b"a", b"ab", b"abc", b"abcd", b"21", b"foobar"]
    keys += [rng.bytes(int(n)) for n in rng.integers(0, 64, 200)]
    for key in keys:
        assert pk.murmur2(key) == jk.murmur2(key)
        for n in (1, 3, 4, 12):
            assert pk.partition_for_key(key, n) == jk.partition_for_key(key, n)
    # librdkafka's rdmurmur2 unittest vectors
    assert [pk.murmur2(k) for k in (b"kafka", b"", b"1234")] == [
        0xD067CF64, 0x106E08D9, 0x9FC97B14]


_member_sets = st.builds(
    lambda members, topics, owned_bits, parts: (members, topics, owned_bits, parts),
    st.lists(st.sampled_from([f"m{i}" for i in range(6)]), min_size=1, max_size=5, unique=True),
    st.lists(st.lists(st.sampled_from(["a", "b", "c"]), min_size=1, max_size=3, unique=True),
             min_size=5, max_size=5),
    st.lists(st.integers(0, 2 ** 12 - 1), min_size=5, max_size=5),
    st.fixed_dictionaries({"a": st.integers(0, 7), "b": st.integers(0, 5),
                           "c": st.integers(1, 4)}))


@settings(max_examples=60, deadline=None)
@given(_member_sets)
def test_assignors_match_jax(draw):
    member_ids, topic_sets, owned_bits, counts = draw
    members = {m: topic_sets[i] for i, m in enumerate(member_ids)}
    topic_parts = {t: list(range(n)) for t, n in counts.items()}
    owned: dict = {}
    for i, m in enumerate(member_ids):  # each bit claims a partition (claims may clash)
        for t in ("a", "b", "c"):
            ps = [p for p in range(4) if owned_bits[i] >> (p + 4 * "abc".index(t)) & 1]
            if ps:
                owned.setdefault(m, {})[t] = ps
    assert pk.range_assign(members, topic_parts) == jk.range_assign(members, topic_parts)
    assert (pk.cooperative_sticky_assign(members, owned, topic_parts)
            == jk.cooperative_sticky_assign(members, owned, topic_parts))


def test_group_protocol_encodings_match_jax():
    for owned in (None, {"t": [2, 0], "u": []}):
        blob = pk.encode_subscription(["u", "t"], owned)
        assert blob == jk.encode_subscription(["u", "t"], owned)
        assert pk.decode_subscription_owned(blob) == jk.decode_subscription_owned(blob)
    a = {"t": [3, 1], "u": [0]}
    assert pk.encode_assignment(a) == jk.encode_assignment(a)
    assert pk.decode_assignment(pk.encode_assignment(a)) == {"t": [1, 3], "u": [0]}


# -- through the JAX package's fake broker -------------------------------------


async def _seed(brokers: str, topic: str, parts: int, per_part: int, seed: int):
    prod = jk.KafkaClient(brokers)
    await prod.connect()
    await prod.refresh_metadata([topic])
    rng = np.random.default_rng(seed)
    for p in range(parts):
        recs = [(None if i % 4 == 0 else f"k{p}-{i}".encode(),
                 f"v{p}-{i}-".encode() + rng.bytes(int(rng.integers(0, 20))))
                for i in range(per_part)]
        await prod.produce(topic, p, recs[:per_part // 2])
        await prod.produce(topic, p, recs[per_part // 2:], compression="gzip")
    await prod.close()


def _meta_free(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "__meta_ingest_time"}


async def _drain(inp, want_rows: int) -> list:
    out, rows = [], 0
    while rows < want_rows:
        batch, ack = await inp.read()
        out.append((batch, ack))
        rows += batch.num_rows
    return out


@pytest.mark.parametrize("static", [False, True], ids=["group", "static_partitions"])
def test_kafka_input_batches_and_commits_match_jax(static):
    async def go():
        broker = FakeKafkaBroker({"t": 3})
        broker.JOIN_WINDOW_S = 0.05
        await broker.start()
        brokers = f"127.0.0.1:{broker.port}"
        try:
            await _seed(brokers, "t", 3, 10, seed=5)
            results = {}
            for name, build, group in (("jax", jax_build, "gj"), ("port", None, "gp")):
                cfg = {"type": "kafka", "brokers": brokers, "topic": "t", "group": group,
                       "batch_size": 4, **({"partitions": [0, 1, 2]} if static else {})}
                inp = (jax_build("input", cfg, JaxResource()) if build
                       else build_component("input", cfg, Resource()))
                await inp.connect()
                got = await _drain(inp, 30)
                for _, ack in got[:-2]:  # the last two stay unacked
                    await ack.ack()
                results[name] = got
                await inp.close()
            jb, pb = results["jax"], results["port"]
            assert len(jb) == len(pb)
            for (j, _), (p, _) in zip(jb, pb):
                assert p.column_names == j.column_names
                assert p.schema == {f.name: str(f.type) for f in j.schema}
                assert _meta_free(p.to_pydict()) == _meta_free(j.to_pydict())
                assert p.column("__meta_ingest_time").dtype == np.int64
            offsets = {g: {k[1:]: v for k, v in broker.group_offsets.items() if k[0] == g}
                       for g in ("gj", "gp")}
            assert offsets["gp"] == offsets["gj"] and offsets["gp"]
        finally:
            stop(broker)

    run(go())


def test_kafka_input_codec_rows_carry_batch_level_meta_like_jax():
    async def go():
        broker = FakeKafkaBroker({"j": 1})
        await broker.start()
        brokers = f"127.0.0.1:{broker.port}"
        try:
            prod = jk.KafkaClient(brokers)
            await prod.connect()
            await prod.refresh_metadata(["j"])
            await prod.produce("j", 0, [(b"a", b'{"x": 1}'), (None, b'[{"x": 2}, {"x": 3}]')])
            await prod.close()
            cfg = {"type": "kafka", "brokers": brokers, "topic": "j", "group": "g",
                   "partitions": [0], "codec": "json"}
            outs = []
            for inp in (jax_build("input", cfg, JaxResource()),
                        build_component("input", cfg, Resource())):
                await inp.connect()
                outs.append((await inp.read())[0])
                await inp.close()
            j, p = outs
            assert p.schema == {f.name: str(f.type) for f in j.schema}
            assert _meta_free(p.to_pydict()) == _meta_free(j.to_pydict())
        finally:
            stop(broker)

    run(go())


def test_cooperative_rebalance_keeps_positions_without_refetch(monkeypatch):
    """The JAX package's KIP-429 scenario on port consumers: a second member
    joins, the first keeps its retained partition's in-memory position (no
    offset re-fetch, no replay) and the revoked one moves."""
    monkeypatch.setattr(port_kafka_in, "HEARTBEAT_INTERVAL_S", 0.05)

    async def go():
        broker = FakeKafkaBroker({"t": 2})
        broker.JOIN_WINDOW_S = 0.2
        await broker.start()
        brokers = f"127.0.0.1:{broker.port}"
        try:
            prod = pk.KafkaClient(brokers)
            await prod.connect()
            await prod.refresh_metadata(["t"])
            for p in (0, 1):
                await prod.produce("t", p, [(None, b"x"), (None, b"y"), (None, b"z")])
            await prod.close()
            cfg = {"type": "kafka", "brokers": brokers, "topic": "t", "group": "g"}
            c1 = build_component("input", cfg, Resource())
            await c1.connect()
            assert c1._rr == [("t", 0), ("t", 1)]
            got = set()
            while got != {0, 1}:
                batch, _ack = await c1.read()
                got.add(batch.get_meta("__meta_partition"))
            before = dict(c1._offsets)
            assert all(v >= 3 for v in before.values())
            fetches = []
            orig = c1._client.offset_fetch

            async def counting(group, topic, p):
                fetches.append(p)
                return await orig(group, topic, p)

            c1._client.offset_fetch = counting
            c2 = build_component("input", cfg, Resource())
            await c2.connect()
            for _ in range(200):
                if (sorted(c1._rr + c2._rr) == [("t", 0), ("t", 1)]
                        and not c1._rejoin_needed.is_set() and not c2._rejoin_needed.is_set()):
                    break
                await asyncio.sleep(0.05)
            assert len(c1._rr) == 1 and len(c2._rr) == 1
            kept = c1._rr[0]
            assert c1._offsets[kept] == before[kept] and kept[1] not in fetches
            assert ({("t", 0), ("t", 1)} - {kept}).pop() not in c1._offsets
            await c1.close()
            await c2.close()
        finally:
            stop(broker)

    run(go())


class _RecordingBroker(FakeKafkaBroker):
    """The JAX fake, keeping each produced batch's codec id."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.produced = []

    def _dispatch(self, api, r, ver=0):
        if api == 0:
            rr = jk.Reader(r.data[r.pos:])
            rr.string(), rr.i16(), rr.i32()
            for _ in range(rr.i32()):
                topic = rr.string()
                for _ in range(rr.i32()):
                    part, batch = rr.i32(), rr.bytes_()
                    codec = struct.unpack(">h", batch[21:23])[0] & 7
                    self.produced.append((topic, part, codec,
                                          [(x.key, x.value) for x in jk.decode_record_batches(batch)]))
        return super()._dispatch(api, r, ver)


@pytest.mark.parametrize("extra", [
    {}, {"compression": "snappy"}, {"compression": "lz4", "key": "k1"},
    {"compression": "gzip", "key": {"value": "dev-7"}, "partitioner": "crc32c"},
    {"compression": "zstd", "codec": "json"}], ids=["rr", "snappy", "lz4_keyed",
                                                    "gzip_crc32c", "zstd_json"])
def test_kafka_output_matches_jax(extra):
    async def go():
        broker = _RecordingBroker({"oj": 4, "op": 4})
        await broker.start()
        brokers = f"127.0.0.1:{broker.port}"
        try:
            rng = np.random.default_rng(6)
            batches = [rng.integers(0, 100, int(n)) for n in (5, 1, 7, 3)]
            for topic, build in (("oj", True), ("op", False)):
                cfg = {"type": "kafka", "brokers": brokers, "topic": topic, **extra}
                out = (jax_build("output", cfg, JaxResource()) if build
                       else build_component("output", cfg, Resource()))
                await out.connect()
                for vals in batches:
                    if "codec" in extra:
                        b = (JaxBatch.from_pydict({"v": vals.tolist()}) if build
                             else MessageBatch.from_pydict({"v": vals.tolist()}))
                    else:
                        payloads = [f"p{x}".encode() for x in vals]
                        b = (JaxBatch.new_binary(payloads) if build
                             else MessageBatch.new_binary(payloads))
                    await out.write(b.with_source("generate"))
                await out.close()
            jp = [(p, c, r) for t, p, c, r in broker.produced if t == "oj"]
            pp = [(p, c, r) for t, p, c, r in broker.produced if t == "op"]
            assert pp == jp and len(pp) >= 4
            assert {c for _, c, _ in pp} == {{None: 0, "gzip": 1, "snappy": 2, "lz4": 3,
                                              "zstd": 4}[extra.get("compression")]}
            for p in range(4):
                assert ([rec[:2] for rec in broker.logs[("op", p)]]
                        == [rec[:2] for rec in broker.logs[("oj", p)]])
        finally:
            stop(broker)

    run(go())


def test_sasl_plain_handshake_matches_jax():
    async def go():
        broker = FakeKafkaBroker({"t": 1}, sasl_plain=("alice", "s3cret"))
        await broker.start()
        brokers = f"127.0.0.1:{broker.port}"
        try:
            outcomes = {}
            for name, mod, err in (("jax", jk, jk.ConnectError), ("port", pk, ConnectError)):
                good = mod.KafkaClient(brokers, sasl={"mechanism": "PLAIN", "username": "alice",
                                                      "password": "s3cret"})
                await good.connect()
                await good.refresh_metadata(["t"])
                parts = good.partitions("t")
                await good.close()
                bad = mod.KafkaClient(brokers, sasl={"mechanism": "PLAIN", "username": "eve",
                                                     "password": "nope"})
                with pytest.raises(err, match="no bootstrap broker reachable") as e:
                    await bad.connect()
                outcomes[name] = (parts, str(e.value))
                with pytest.raises(err, match="PLAIN only"):
                    await mod.KafkaClient(brokers, sasl={"mechanism": "SCRAM-SHA-256"}).connect()
            assert outcomes["port"] == outcomes["jax"]
            assert broker.sasl_attempts == ["alice", "eve"] * 2
        finally:
            stop(broker)

    run(go())


def test_sasl_password_env_indirection(monkeypatch):
    monkeypatch.setenv("KAFKA_PW", "from-env")
    kw = pk.client_kwargs_from_config({"sasl": {"mechanism": "PLAIN", "username": "u",
                                                "password": "${KAFKA_PW}"}})
    assert kw["sasl"]["password"] == "from-env"
    assert kw == jk.client_kwargs_from_config({"sasl": {"mechanism": "PLAIN", "username": "u",
                                                        "password": "${KAFKA_PW}"}})


# -- configs ----------------------------------------------------------------------


@pytest.mark.parametrize("assignor", ["sticky-nonsense", "range,roundrobin", " , "])
def test_refused_assignors_raise_jax_message(assignor):
    cfg = {"type": "kafka", "brokers": "b:1", "topic": "t", "group": "g", "assignor": assignor}
    with pytest.raises(JaxConfigError) as je:
        jax_build("input", cfg, JaxResource())
    with pytest.raises(ConfigError) as pe:
        check_component("input", cfg)
    assert str(pe.value) == str(je.value)
    with pytest.raises(ConfigError) as pe:
        build_component("input", cfg, Resource())
    assert str(pe.value) == str(je.value)


def test_range_assignor_forces_eager():
    inp = build_component("input", {"type": "kafka", "brokers": "b:1", "topic": "t",
                                    "group": "g", "assignor": "range"}, Resource())
    assert inp.assignors == ("range",)


@pytest.mark.parametrize("cfg,records,want", [
    ({"tenant": "team-a"}, [(b"v", None)], ["team-a"]),
    ({"tenant": "static-team", "tenant_header": "x-tenant"},
     [(b"v", {b"x-tenant": b"acme"}), (b"w", {b"x-tenant": b"other"})], ["acme", "acme"]),
], ids=["tenant", "tenant_header"])
def test_kafka_tenant_keys_stamp_as_jax(cfg, records, want):
    """``tenant`` stamps every batch, ``tenant_header`` the fetch's first
    record's header (it wins over ``tenant``; a record without it falls back
    to ``tenant``), as JAX's input does: the batches are equal."""
    full = {"type": "kafka", "brokers": "b:1", "topic": "t", "group": "g", **cfg}
    jinp, pinp = jax_build("input", full, JaxResource()), build_component("input", full,
                                                                         Resource())
    got = {}
    for name, inp, mod in (("jax", jinp, jk), ("port", pinp, pk)):
        recs = [mod.KafkaRecord(i, 1000 + i, None, v, h) for i, (v, h) in enumerate(records)]
        batches = [inp._records_to_batch(recs, "t", 0),
                   inp._records_to_batch([mod.KafkaRecord(9, 9, None, b"z")], "t", 0)]
        got[name] = [{k: v for k, v in b.to_pydict().items() if k != "__meta_ingest_time"}
                     for b in batches]
    assert got["port"] == got["jax"]
    assert got["port"][0]["__meta_ext_tenant"] == want
    assert got["port"][1]["__meta_ext_tenant"] == [cfg["tenant"]]


@pytest.mark.parametrize("family,cfg,match", [
    ("input", {"pause_on_overload": True}, "'pause_on_overload' is not yet ported"),
    ("output", {"key": {"expr": "json_get_str(__value__, 'label')"}}, None),
    ("output", {"topic": {"expr": "concat('t-', city)"}}, None),
], ids=["unknown_key", "key_expr", "topic_expr"])
def test_unported_kafka_keys_raise_at_validate_and_build(family, cfg, match):
    """A key the port does not carry raises at validate and at build; the
    ``{expr: ...}`` key and topic, refused until the SQL engine was ported,
    now pass both (``match`` None)."""
    base = {"type": "kafka", "brokers": "b:1", "topic": "t",
            **({"group": "g"} if family == "input" else {})}
    full = {**base, **cfg}
    if match is None:
        check_component(family, full)
        out = build_component(family, full, Resource())
        assert all(getattr(out, k).is_expr for k in cfg)
        return
    with pytest.raises(ConfigError, match=match):
        check_component(family, full)
    with pytest.raises(ConfigError, match=match):
        build_component(family, full, Resource())


def test_kafka_config_errors_match_jax():
    for family, cfg in (("input", {"type": "kafka", "brokers": "b:1", "group": "g"}),
                        ("input", {"type": "kafka", "topic": "t", "group": "g"}),
                        ("input", {"type": "kafka", "brokers": "b:1", "topic": "t",
                                   "group": "g", "start": "middle"}),
                        ("input", {"type": "kafka", "brokers": "b:1", "topics": ["a", "b"],
                                   "group": "g", "partitions": [0]}),
                        ("output", {"type": "kafka", "brokers": "b:1"}),
                        ("output", {"type": "kafka", "brokers": "b:1", "topic": "t",
                                    "compression": "brotli"}),
                        ("output", {"type": "kafka", "brokers": "b:1", "topic": "t",
                                    "partitioner": "random"})):
        with pytest.raises(JaxConfigError) as je:
            jax_build(family, cfg, JaxResource())
        with pytest.raises(ConfigError) as pe:
            check_component(family, cfg)
        assert str(pe.value) == str(je.value)


def test_meta_columns_of_the_port_batch_match_jax_stampers():
    j = (JaxBatch.new_binary([b"a", b"b"]).with_partition(3).with_offset(9)
         .with_timestamp(5).with_ingest_time(11))
    p = (MessageBatch.new_binary([b"a", b"b"]).with_partition(3).with_offset(9)
         .with_timestamp(5).with_ingest_time(11))
    assert p.schema == {f.name: str(f.type) for f in j.schema}
    assert p.to_pydict() == j.to_pydict()
    now = MessageBatch.new_binary([b"a"]).with_ingest_time().get_meta("__meta_ingest_time")
    assert abs(now - JaxBatch.new_binary([b"a"]).with_ingest_time().get_meta(
        "__meta_ingest_time")) < 60_000
