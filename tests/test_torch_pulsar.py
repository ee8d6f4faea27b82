"""The port's Pulsar codec, client, input and output against the JAX package's.

- The proto2 codec (``connect/pulsar_proto.py``) against ``google.protobuf``
  compiled from JAX's ``PULSAR_API_PROTO`` (``proto()``), both ways and under
  ``hypothesis``, for every message the client sends or reads: the port's
  bytes equal ``SerializeToString()``, and the port's decode of google's
  bytes gives google's fields, unknown fields of every wire type kept and
  written back.
- JAX's tests of ``tests/test_pulsar.py``, each mirrored with the port's
  client, input and output against JAX's ``FakePulsarBroker`` (whose codec is
  google's, so a fault in the port's codec cannot hide behind a fake that
  shares it), OAuth2 against JAX's ``FakeOAuthServer``.
- JAX's client against the port's ``FakePulsarBroker``: the same payloads,
  acks and redeliveries, batched entries, PING/PONG and the broker's
  CLOSE_CONSUMER.
"""

from __future__ import annotations

import asyncio
import base64
import json
import struct

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import arkflow_tpu.connect.pulsar_client as jpc
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.errors import Disconnection as JaxDisconnection
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, build_component, check_component
from arkflow_tpu_torch.components import ensure_plugins_loaded
from arkflow_tpu_torch.config import StreamConfig
from arkflow_tpu_torch.connect import pulsar_client as ppc
from arkflow_tpu_torch.connect.pulsar_proto import (ENUMS, MESSAGES, EncodeError, Message)
from arkflow_tpu_torch.errors import (ConfigError, ConnectError, Disconnection, ReadError,
                                      WriteError)
from arkflow_tpu_torch.runtime.stream import build_stream
from arkflow_tpu_torch.tools.fake_brokers import FakePulsarBroker as PortFakeBroker
from arkflow_tpu_torch.utils.retry import RetryConfig, retry_with_backoff
from tests.test_pulsar import FakeOAuthServer, FakePulsarBroker

jax_plugins()
ensure_plugins_loaded()
P = jpc.proto()


def run(coro, timeout: float = 20.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def stop(*fakes) -> None:
    """Stop a fake's listener without waiting on its idle peers."""
    for f in fakes:
        (f._server if isinstance(f, FakePulsarBroker) else f.server).close()


# -- the codec -------------------------------------------------------------------

#: every message the client or the fakes send or read
WIRE_MESSAGES = sorted(MESSAGES)

_INT = {"int32": (-2 ** 31, 2 ** 31 - 1), "int64": (-2 ** 63, 2 ** 63 - 1),
        "uint32": (0, 2 ** 32 - 1), "uint64": (0, 2 ** 64 - 1)}


def _scalar(draw, f):
    if f.kind == "enum":
        return draw(st.sampled_from(sorted(ENUMS[f.type].values())))
    if f.kind == "message":
        return draw(message_values(f.type, depth=1))
    if f.type == "string":
        return draw(st.text(max_size=6))
    if f.type == "bytes":
        return draw(st.binary(max_size=6))
    if f.type == "bool":
        return draw(st.booleans())
    lo, hi = _INT[f.type]
    return draw(st.one_of(st.integers(lo, hi), st.sampled_from([lo, hi, 0, -1 if lo else 1])))


@st.composite
def message_values(draw, name: str, depth: int = 0):
    """Field values of one message: required fields always, optional and
    repeated ones sometimes (nested messages to a depth of 3)."""
    out = {}
    for fname, f in MESSAGES[name].items():
        if f.kind == "message" and depth >= 2 and f.label != "required":
            continue
        if f.label == "repeated":
            n = draw(st.integers(0, 2))
            if n:
                out[fname] = [_scalar(draw, f) for _ in range(n)]
        elif f.label == "required" or draw(st.booleans()):
            out[fname] = _scalar(draw, f)
    return (name, out)


def to_port(spec) -> Message:
    name, values = spec
    m = Message(name)
    for k, v in values.items():
        f = MESSAGES[name][k]
        if f.kind == "message":
            v = [to_port(x) for x in v] if f.label == "repeated" else to_port(v)
        setattr(m, k, v)
    return m


def fill_google(g, spec) -> None:
    name, values = spec
    for k, v in values.items():
        f = MESSAGES[name][k]
        if f.kind == "message":
            if f.label == "repeated":
                for x in v:
                    fill_google(getattr(g, k).add(), x)
            else:
                getattr(g, k).SetInParent()  # present even when empty
                fill_google(getattr(g, k), v)
        elif f.label == "repeated":
            getattr(g, k).extend(v)
        else:
            setattr(g, k, v)


def google_of(spec):
    cls = P[spec[0]] if spec[0] in P else None
    if cls is None:
        from google.protobuf import message_factory

        cls = message_factory.GetMessageClass(
            P["pool"].FindMessageTypeByName(f"pulsar.proto.{spec[0]}"))
    g = cls()
    fill_google(g, spec)
    return g


def google_dict(g) -> dict:
    out = {}
    for fd, v in g.ListFields():
        if fd.message_type is not None:
            v = ([google_dict(x) for x in v] if fd.is_repeated
                 else google_dict(v))
        elif fd.is_repeated:
            v = list(v)
        out[fd.name] = v
    return out


def _ordered(d: dict, name: str) -> dict:
    """google's ``ListFields`` is in field-number order, as ``to_dict``."""
    return {k: d[k] for k in MESSAGES[name] if k in d}


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.sampled_from(WIRE_MESSAGES).flatmap(message_values))
def test_codec_bytes_and_fields_match_google(spec):
    g, p = google_of(spec), to_port(spec)
    raw = g.SerializeToString()
    assert p.encode() == raw
    back = Message.decode(spec[0], raw)
    assert back.to_dict() == _ordered(google_dict(g), spec[0])
    assert back.encode() == raw
    gback = type(g)()
    gback.ParseFromString(p.encode())
    assert gback == g


_UNKNOWN = st.one_of(
    st.tuples(st.just(0), st.integers(0, 2 ** 64 - 1)),
    st.tuples(st.just(1), st.binary(min_size=8, max_size=8)),
    st.tuples(st.just(2), st.binary(max_size=5)),
    st.tuples(st.just(5), st.binary(min_size=4, max_size=4)),
    st.tuples(st.just(3), st.integers(0, 300)),
)


def _unknown_bytes(number: int, wire: int, value) -> bytes:
    def varint(n):
        out = bytearray()
        while n > 0x7F:
            out.append((n & 0x7F) | 0x80)
            n >>= 7
        out.append(n)
        return bytes(out)

    tag = varint(number << 3 | wire)
    if wire == 0:
        return tag + varint(value)
    if wire == 2:
        return tag + varint(len(value)) + value
    if wire == 3:  # a group holding one varint field, then its end tag
        return tag + varint(1 << 3) + varint(value) + varint(number << 3 | 4)
    return tag + value


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.sampled_from(WIRE_MESSAGES).flatmap(message_values),
       st.lists(st.tuples(st.integers(40, 2000), _UNKNOWN), max_size=3))
def test_codec_keeps_unknown_fields_as_google_does(spec, unknown):
    """A newer broker's fields: the port skips each wire type, keeps the
    bytes and writes them back after the known fields, as upb does."""
    raw = google_of(spec).SerializeToString()
    for number, (wire, value) in unknown:
        raw += _unknown_bytes(number, wire, value)
    g = type(google_of(spec))()
    g.ParseFromString(raw)
    p = Message.decode(spec[0], raw)
    assert p.to_dict() == _ordered(google_dict(g), spec[0])
    assert p.encode(partial=True) == g.SerializePartialToString()


def test_codec_presence_defaults_and_required():
    assert Message("CommandProducerSuccess").last_sequence_id == -1
    assert Message("MessageIdData").partition == -1 == P["MessageIdData"]().partition
    assert Message("CommandSubscribe").durable is True
    assert Message("BaseCommand").type == P["BaseCommand"]().type == 2
    assert Message("CommandSend").num_messages == 1
    assert not Message("BaseCommand").has("connect")
    with pytest.raises(EncodeError, match="missing required fields: entryId"):
        Message("MessageIdData", ledgerId=1).encode()
    g = P["MessageIdData"](ledgerId=1)
    with pytest.raises(Exception, match="missing required fields: entryId"):
        g.SerializeToString()
    nested = Message("BaseCommand", type=11, flow=Message("CommandFlow", consumer_id=1))
    with pytest.raises(EncodeError, match="flow.messagePermits"):
        nested.encode()
    # an enum value outside the enum is an unknown field; a message seen twice merges
    raw = b"\x08\x63"
    g = P["BaseCommand"]()
    g.ParseFromString(raw)
    p = Message.decode("BaseCommand", raw)
    assert (p.has("type"), p.type) == (g.HasField("type"), g.type) == (False, 2)
    raw = b"\x08\x0b" + b"\x5a\x02\x08\x01" + b"\x5a\x02\x10\x05"
    g.ParseFromString(raw)
    assert Message.decode("BaseCommand", raw).flow.to_dict() == google_dict(g.flow)


def test_frames_match_jax():
    """The simple and payload frames of one command, byte for byte."""
    cmd = ppc.command(ppc.SEND, "send", producer_id=3, sequence_id=9)
    meta = Message("MessageMetadata", producer_name="p", sequence_id=9, publish_time=5,
                   partition_key="k")
    meta.add("properties", key="a", value="1")
    gcmd = P["BaseCommand"]()
    gcmd.ParseFromString(cmd.encode())
    gmeta = P["MessageMetadata"]()
    gmeta.ParseFromString(meta.encode())
    assert ppc.encode_simple(cmd) == jpc.encode_simple(gcmd)
    frame = ppc.encode_payload_cmd(cmd, meta, b"payload")
    assert frame == jpc.encode_payload_cmd(gcmd, gmeta, b"payload")
    (csize,) = struct.unpack_from(">I", frame, 4)
    pm, pmsgs = ppc.decode_payload_section(frame[8 + csize:])
    jm, jmsgs = jpc.decode_payload_section(frame[8 + csize:])
    assert pm.to_dict() == google_dict(jm)
    assert [(m.payload, m.properties, m.partition_key) for m in pmsgs] == [
        (m.payload, m.properties, m.partition_key) for m in jmsgs]


# -- JAX's tests, with the port's client against JAX's fake -------------------------


def test_url_and_topic_validation():
    assert ppc.parse_service_url("pulsar://h") == ("h", 6650, False)
    assert ppc.parse_service_url("pulsar+ssl://h:6651") == ("h", 6651, True)
    with pytest.raises(ConfigError):
        ppc.parse_service_url("http://h:6650")
    assert ppc.validate_topic("t") == "persistent://public/default/t"
    assert ppc.validate_topic("non-persistent://a/b/c") == "non-persistent://a/b/c"
    for bad in ("bad://a/b/c", "persistent://a/b", "a/b/c", " "):
        with pytest.raises(ConfigError):
            ppc.validate_topic(bad)
        with pytest.raises(JaxConfigError):
            jpc.validate_topic(bad)


def test_payload_checksum_rejected_on_corruption():
    cmd = ppc.command(ppc.SEND, "send", producer_id=1, sequence_id=1)
    meta = Message("MessageMetadata", producer_name="p", sequence_id=1, publish_time=1)
    frame = bytearray(ppc.encode_payload_cmd(cmd, meta, b"payload"))
    frame[-1] ^= 0xFF
    (csize,) = struct.unpack_from(">I", frame, 4)
    with pytest.raises(ReadError, match="checksum mismatch"):
        ppc.decode_payload_section(bytes(frame[8 + csize:]))


def test_produce_consume_ack_roundtrip():
    async def go():
        broker = FakePulsarBroker()
        await broker.start()
        try:
            client = ppc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}")
            cons = await client.subscribe("t", "sub1", sub_type="shared",
                                          initial_position="earliest")
            prod = await client.create_producer("t")
            mid = await prod.send(b"hello", key="k1", properties={"a": "1"})
            assert mid.entryId == 1
            msg = await asyncio.wait_for(cons.receive(), 5)
            assert (msg.payload, msg.partition_key) == (b"hello", "k1")
            await cons.ack(msg.message_id)
            await prod.close()
            await cons.close()
            await client.close()
            await asyncio.sleep(0.05)
            assert broker.acked and broker.acked[0][1] == 1
            assert ("persistent://public/default/t", "sub1", 1) in broker.subscriptions
        finally:
            stop(broker)

    run(go())


def test_flow_permits_regrant_allows_long_streams():
    async def go():
        broker = FakePulsarBroker()
        await broker.start()
        try:
            client = ppc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}")
            cons = await client.subscribe("t", "s", receive_queue=4)
            prod = await client.create_producer("t")
            for i in range(20):
                await prod.send(f"m{i}".encode())
            got = [(await asyncio.wait_for(cons.receive(), 5)).payload for _ in range(20)]
            assert got == [f"m{i}".encode() for i in range(20)]
            await client.close()
        finally:
            stop(broker)

    run(go())


def test_lookup_redirect_followed():
    async def go():
        owner = FakePulsarBroker()
        await owner.start()
        front = FakePulsarBroker(redirect_to=owner)
        await front.start()
        try:
            client = ppc.PulsarClient(f"pulsar://127.0.0.1:{front.port}")
            prod = await client.create_producer("t")
            await prod.send(b"via-redirect")
            assert front.lookups >= 1
            assert owner.topics["persistent://public/default/t"][0][0] == b"via-redirect"
            await client.close()
        finally:
            stop(front, owner)

    run(go())


def test_token_auth_enforced():
    async def go():
        broker = FakePulsarBroker(required_token="s3cret")
        await broker.start()
        try:
            ok = ppc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}",
                                  auth_method="token", auth_data=b"s3cret")
            await ok.create_producer("t")
            await ok.close()
            bad = ppc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}",
                                   auth_method="token", auth_data=b"wrong")
            with pytest.raises((ConnectError, Disconnection), match="bad token"):
                await bad.create_producer("t")
            await bad.close()
        finally:
            stop(broker)

    run(go())


def _batch_frame(consumer_id: int, ledger: int, entry: int, payloads: list[bytes]) -> bytes:
    cmd = ppc.command(ppc.MESSAGE, "message", consumer_id=consumer_id,
                      message_id=Message("MessageIdData", ledgerId=ledger, entryId=entry))
    mm = Message("MessageMetadata", producer_name="fake", sequence_id=1, publish_time=1,
                 num_messages_in_batch=len(payloads))
    body = b""
    for pl in payloads:
        sb = Message("SingleMessageMetadata", payload_size=len(pl)).encode()
        body += struct.pack(">I", len(sb)) + sb + pl
    return ppc.encode_payload_cmd(cmd, mm, body)


def test_batched_message_delivery():
    async def go():
        broker = FakePulsarBroker()
        await broker.start()
        try:
            client = ppc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}")
            cons = await client.subscribe("t", "s")
            state = broker._consumers[cons.consumer_id]
            state["writer"].write(_batch_frame(cons.consumer_id, 9, 77, [b"one", b"two"]))
            await state["writer"].drain()
            m1 = await asyncio.wait_for(cons.receive(), 5)
            m2 = await asyncio.wait_for(cons.receive(), 5)
            assert (m1.payload, m2.payload) == (b"one", b"two")
            assert (m1.message_id.batch_index, m2.message_id.batch_index) == (0, 1)
            assert m1.message_id.entryId == 77
            await client.close()
        finally:
            stop(broker)

    run(go())


def test_send_error_surfaces_and_output_retry_recovers():
    async def go():
        broker = FakePulsarBroker(fail_sends=1)
        await broker.start()
        try:
            client = ppc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}")
            prod = await client.create_producer("t")
            with pytest.raises(WriteError, match="injected failure"):
                await prod.send(b"will-fail")
            await prod.send(b"recovers")
            assert broker.topics["persistent://public/default/t"][0][0] == b"recovers"
            await client.close()
        finally:
            stop(broker)

    run(go())


def test_input_output_components_end_to_end():
    async def go():
        broker = FakePulsarBroker()
        await broker.start()
        try:
            url = f"pulsar://127.0.0.1:{broker.port}"
            out = build_component("output", {"type": "pulsar", "service_url": url,
                                             "topic": "t", "codec": "json"}, Resource())
            inp = build_component("input", {
                "type": "pulsar", "service_url": url, "topic": "t",
                "subscription_name": "arkflow", "subscription_type": "shared",
                "initial_position": "earliest", "codec": "json"}, Resource())
            await out.connect()
            await inp.connect()
            await out.write(MessageBatch.from_pydict({"city": ["sf", "la"], "v": [1, 2]}))
            b1, ack1 = await asyncio.wait_for(inp.read(), 5)
            b2, ack2 = await asyncio.wait_for(inp.read(), 5)
            rows = b1.to_pydict()["city"] + b2.to_pydict()["city"]
            assert sorted(rows) == ["la", "sf"]
            assert b1.to_pydict()["__meta_source"] == ["pulsar"]
            assert b1.to_pydict()["__meta_ext_topic"] == ["persistent://public/default/t"]
            await ack1.ack()
            await ack2.ack()
            await asyncio.sleep(0.05)
            assert len(broker.acked) == 2
            await inp.close()
            await out.close()
        finally:
            stop(broker)

    run(go())


def test_oauth2_end_to_end_token_fetch_and_connect(tmp_path):
    async def go():
        oauth = FakeOAuthServer(token="tok-e2e")
        await oauth.start()
        broker = FakePulsarBroker(required_token="tok-e2e")
        await broker.start()
        key = tmp_path / "key.json"
        key.write_text(json.dumps({"client_id": "cid", "client_secret": "sec"}))
        auth = {"type": "oauth2", "issuer_url": f"http://127.0.0.1:{oauth.port}",
                "credentials_url": f"file://{key}", "audience": "urn:pulsar:cluster",
                "scope": "produce consume"}
        try:
            url = f"pulsar://127.0.0.1:{broker.port}"
            out = build_component("output", {"type": "pulsar", "service_url": url, "topic": "t",
                                             "codec": "json", "auth": auth}, Resource())
            inp = build_component("input", {"type": "pulsar", "service_url": url, "topic": "t",
                                            "subscription_name": "s",
                                            "initial_position": "earliest", "codec": "json",
                                            "auth": auth}, Resource())
            await out.connect()
            await inp.connect()
            await out.write(MessageBatch.from_pydict({"v": [7]}))
            b, ack = await asyncio.wait_for(inp.read(), 5)
            assert b.to_pydict()["v"] == [7]
            await ack.ack()
            await inp.close()
            await out.close()
        finally:
            stop(broker)
            stop(oauth)
        grant = oauth.grants[0]
        assert grant == {"grant_type": "client_credentials", "client_id": "cid",
                         "client_secret": "sec", "audience": "urn:pulsar:cluster",
                         "scope": "produce consume"}

    run(go())


def test_oauth2_bad_token_rejected_by_broker(tmp_path):
    async def go():
        oauth = FakeOAuthServer(token="wrong")
        await oauth.start()
        broker = FakePulsarBroker(required_token="right")
        await broker.start()
        key = tmp_path / "key.json"
        key.write_text(json.dumps({"client_id": "c", "client_secret": "s"}))
        try:
            inp = build_component("input", {
                "type": "pulsar", "service_url": f"pulsar://127.0.0.1:{broker.port}",
                "topic": "t", "subscription_name": "s", "retry": {"max_attempts": 1},
                "auth": {"type": "oauth2", "issuer_url": f"http://127.0.0.1:{oauth.port}",
                         "credentials_url": f"file://{key}", "audience": "a"}}, Resource())
            with pytest.raises(ConnectError, match="bad token"):
                await asyncio.wait_for(inp.connect(), 10)
        finally:
            stop(broker)
            stop(oauth)

    run(go())


PULSAR_CONFIG_ERRORS = [
    ("input", {"type": "pulsar", "topic": "t", "subscription_name": "s"}, "service_url"),
    ("input", {"type": "pulsar", "service_url": "pulsar://h", "topic": "t",
               "subscription_name": "s", "subscription_type": "bogus"}, "subscription_type"),
    ("input", {"type": "pulsar", "service_url": "pulsar://h", "topic": "t",
               "subscription_name": "s", "initial_position": "middle"}, "initial_position"),
    ("output", {"type": "pulsar", "service_url": "kafka://h", "topic": "t"}, "service_url"),
    ("output", {"type": "pulsar", "service_url": "pulsar://h", "topic": "a/b"}, "slashes"),
    ("output", {"type": "pulsar", "service_url": "pulsar://h", "topic": "t",
                "auth": {"type": "oauth2", "credentials_url": "file:///k.json",
                         "audience": "z"}}, "issuer_url"),
    ("output", {"type": "pulsar", "service_url": "pulsar://h", "topic": "t",
                "auth": {"type": "oauth2", "issuer_url": "x", "credentials_url": "ftp://y",
                         "audience": "z"}}, "credentials_url"),
    ("output", {"type": "pulsar", "service_url": "pulsar://h", "topic": "t",
                "auth": {"type": "basic"}}, "not supported"),
    ("output", {"type": "pulsar", "service_url": "pulsar://h", "topic": "t",
                "auth": {"type": "token"}}, "requires 'token'"),
    ("input", {"type": "pulsar", "service_url": "pulsar://h", "topic": "t",
               "subscription_name": "s", "retry": {"max_attempts": 0}}, "max_attempts"),
    ("input", {"type": "pulsar", "service_url": "pulsar://h", "topic": "t",
               "subscription_name": "s", "retry_config": {"max_attempts": 0}}, "max_attempts"),
]


@pytest.mark.parametrize("family,cfg,match", PULSAR_CONFIG_ERRORS,
                         ids=[f"{f}-{m}" for f, _, m in PULSAR_CONFIG_ERRORS])
def test_pulsar_config_validation_matches_jax(family, cfg, match):
    """Refused at ``--validate`` and at build, with JAX's message."""
    with pytest.raises(JaxConfigError) as jerr:
        jax_build(family, cfg, JaxResource())
    for call in (lambda: check_component(family, cfg),
                 lambda: build_component(family, cfg, Resource())):
        with pytest.raises(ConfigError, match=match) as err:
            call()
        assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("family,cfg", [
    ("input", {"type": "pulsar", "service_url": "pulsar://h", "topic": "t",
               "subscription_name": "s", "batch_size": 10}),
    ("output", {"type": "pulsar", "service_url": "pulsar://h", "topic": "t", "key": "k"}),
])
def test_unported_pulsar_keys_refused(family, cfg):
    with pytest.raises(ConfigError, match="not yet ported"):
        check_component(family, cfg)


def test_retry_backoff_delays():
    rc = RetryConfig(max_attempts=5, initial_delay_ms=100, max_delay_ms=1000,
                     backoff_multiplier=2.0)
    assert [rc.delay_s(i) for i in range(5)] == [0.1, 0.2, 0.4, 0.8, 1.0]


def test_pulsar_full_stream_e2e_with_ack_chain():
    """pulsar input -> SQL -> pulsar output through the port's stream; the
    broker acks fire only after the write succeeded."""
    async def go():
        broker = FakePulsarBroker()
        await broker.start()
        url = f"pulsar://127.0.0.1:{broker.port}"
        seed = ppc.PulsarClient(url)
        prod = await seed.create_producer("in-t")
        for i in range(6):
            await prod.send(f'{{"v": {i}}}'.encode())
        stream = build_stream(StreamConfig.from_mapping({
            "name": "pulsar-e2e",
            "input": {"type": "pulsar", "service_url": url, "topic": "in-t",
                      "subscription_name": "s", "initial_position": "earliest",
                      "codec": "json"},
            "pipeline": {"thread_num": 2, "processors": [
                {"type": "sql", "query": "SELECT v * 10 AS v10 FROM flow"}]},
            "output": {"type": "pulsar", "service_url": url, "topic": "out-t", "codec": "json"},
        }), name="pulsar-e2e")
        cancel = asyncio.Event()

        async def stop_later():
            for _ in range(100):
                await asyncio.sleep(0.05)
                if len(broker.topics.get("persistent://public/default/out-t", [])) >= 6:
                    break
            await asyncio.sleep(0.05)
            cancel.set()

        await asyncio.gather(stream.run(cancel), stop_later())
        out = broker.topics.get("persistent://public/default/out-t", [])
        assert sorted(p for p, _ in out) == [f'{{"v10": {i * 10}}}'.encode() for i in range(6)]
        assert len(broker.acked) == 6
        await seed.close()
        stop(broker)

    run(go())


def test_batched_entry_ack_held_until_all_siblings_acked():
    async def go():
        broker = FakePulsarBroker()
        await broker.start()
        try:
            client = ppc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}")
            cons = await client.subscribe("t", "s")
            state = broker._consumers[cons.consumer_id]
            state["writer"].write(_batch_frame(cons.consumer_id, 5, 42, [b"one", b"two"]))
            await state["writer"].drain()
            m1 = await asyncio.wait_for(cons.receive(), 5)
            m2 = await asyncio.wait_for(cons.receive(), 5)
            await cons.ack(m1.message_id)
            await asyncio.sleep(0.1)
            assert broker.acked == []
            await cons.ack(m2.message_id)
            await asyncio.sleep(0.1)
            assert broker.acked == [(5, 42, -1)]
            await client.close()
        finally:
            stop(broker)

    run(go())


def test_broker_initiated_close_consumer_surfaces_disconnection():
    async def go():
        broker = FakePulsarBroker()
        await broker.start()
        try:
            client = ppc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}")
            cons = await client.subscribe("t", "s")
            state = broker._consumers[cons.consumer_id]
            state["writer"].write(ppc.encode_simple(ppc.command(
                ppc.CLOSE_CONSUMER, "close_consumer", consumer_id=cons.consumer_id,
                request_id=999)))
            await state["writer"].drain()
            with pytest.raises(Disconnection):
                await asyncio.wait_for(cons.receive(), 5)
            await client.close()
        finally:
            stop(broker)

    run(go())


def test_auth_challenge_answered_with_refreshed_token():
    async def go():
        broker = FakePulsarBroker(required_token="tok-1", challenge_after_connect=True)
        await broker.start()
        refreshes = 0

        async def refresh() -> bytes:
            nonlocal refreshes
            refreshes += 1
            return b"tok-2"

        try:
            client = ppc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}",
                                      auth_method="token", auth_data=b"tok-1",
                                      auth_refresh=refresh)
            cons = await client.subscribe("t", "s")
            for _ in range(100):
                if broker.auth_responses:
                    break
                await asyncio.sleep(0.02)
            assert broker.auth_responses == [("token", b"tok-2")]
            assert refreshes == 1
            assert not cons.conn._closed
            assert client.auth_data == b"tok-2"
            await client.close()
        finally:
            stop(broker)

    run(go())


def test_auth_challenge_without_refresh_reuses_static_data():
    async def go():
        broker = FakePulsarBroker(required_token="tok-static", challenge_after_connect=True)
        await broker.start()
        try:
            client = ppc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}",
                                      auth_method="token", auth_data=b"tok-static")
            await client.subscribe("t", "s")
            for _ in range(100):
                if broker.auth_responses:
                    break
                await asyncio.sleep(0.02)
            assert broker.auth_responses == [("token", b"tok-static")]
            await client.close()
        finally:
            stop(broker)

    run(go())


def test_oauth2_credentials_url_data_and_http():
    async def go():
        oauth = FakeOAuthServer(token="tok-d")
        await oauth.start()
        key_json = json.dumps({"client_id": "cid", "client_secret": "sec"})
        data_url = "data:application/json;base64," + base64.b64encode(key_json.encode()).decode()
        try:
            auth = {"type": "oauth2", "issuer_url": f"http://127.0.0.1:{oauth.port}",
                    "credentials_url": data_url, "audience": "aud"}
            assert ppc.auth_from_config(auth) == ("oauth2", None)
            assert await ppc.fetch_oauth2_token(auth) == b"tok-d"
            auth_http = dict(auth, credentials_url=f"http://127.0.0.1:{oauth.port}/key.json")
            assert ppc.auth_from_config(auth_http) == ("oauth2", None)
            assert await ppc.fetch_oauth2_token(auth_http) == b"tok-d"
            assert oauth.grants[-1]["client_id"] == "cid"
            auth_404 = dict(auth, credentials_url=f"http://127.0.0.1:{oauth.port}/gone.json")
            with pytest.raises(ConnectionError):
                await ppc.fetch_oauth2_token(auth_404)
        finally:
            stop(oauth)

    run(go())


def test_oauth2_missing_key_file_fails_fast_not_retried(tmp_path):
    async def go():
        auth = {"type": "oauth2", "issuer_url": "http://127.0.0.1:1",
                "credentials_url": f"file://{tmp_path}/nope.json", "audience": "aud"}
        attempts = 0

        async def op():
            nonlocal attempts
            attempts += 1
            return await ppc.fetch_oauth2_token(auth)

        with pytest.raises(ConfigError, match="key file not found"):
            await retry_with_backoff(op, RetryConfig(max_attempts=5, initial_delay_ms=200),
                                     what="token")
        assert attempts == 1

    run(go())


# -- JAX's client against the port's fake --------------------------------------------


def test_jax_client_against_port_fake_broker():
    """Payloads, keys, acks and redeliveries: a subscription's unacked
    messages come back to the next consumer with their redelivery count."""
    async def go():
        broker = PortFakeBroker()
        await broker.start()
        try:
            client = jpc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}")
            cons = await client.subscribe("t", "s", initial_position="earliest")
            prod = await client.create_producer("t")
            for i in range(6):
                await prod.send(f"m{i}".encode(), key=f"k{i % 2}")
            got = [await asyncio.wait_for(cons.receive(), 5) for _ in range(6)]
            assert [(m.payload, m.partition_key) for m in got] == [
                (f"m{i}".encode(), f"k{i % 2}") for i in range(6)]
            for m in got[:4]:
                await cons.ack(m.message_id)
            await cons.close()
            again = await client.subscribe("t", "s", initial_position="earliest")
            back = [await asyncio.wait_for(again.receive(), 5) for _ in range(2)]
            assert [(m.payload, m.redelivery_count) for m in back] == [(b"m4", 1), (b"m5", 1)]
            for m in back:
                await again.ack(m.message_id)
            await asyncio.sleep(0.05)
            assert broker.unacked("persistent://public/default/t", "s") == 0
            assert broker.redelivered == 2
            assert [a[1] for a in broker.acked] == [1, 2, 3, 4, 5, 6]
            assert ("persistent://public/default/t", "s", 0) in broker.subscriptions
            await client.close()
        finally:
            await broker.stop()

    run(go())


def test_jax_client_batched_entry_ping_and_close_on_port_fake():
    async def go():
        broker = PortFakeBroker(fail_sends=1)
        await broker.start()
        try:
            client = jpc.PulsarClient(f"pulsar://127.0.0.1:{broker.port}")
            cons = await client.subscribe("t", "s", initial_position="earliest")
            entry = await broker.publish_batch("t", [b"one", b"two", b"three"])
            msgs = [await asyncio.wait_for(cons.receive(), 5) for _ in range(3)]
            assert [(m.payload, m.message_id.batch_index) for m in msgs] == [
                (b"one", 0), (b"two", 1), (b"three", 2)]
            for m in msgs:
                await cons.ack(m.message_id)
            await asyncio.sleep(0.05)
            assert broker.acked == [(1, entry, -1)]
            prod = await client.create_producer("t")
            from arkflow_tpu.errors import WriteError as JaxWriteError

            with pytest.raises(JaxWriteError, match="injected failure"):
                await prod.send(b"x")
            await broker.ping_all()
            for _ in range(50):
                if broker.pongs:
                    break
                await asyncio.sleep(0.01)
            assert broker.pongs == 1
            await broker.close_consumer(cons.consumer_id)
            with pytest.raises(JaxDisconnection):
                await asyncio.wait_for(cons.receive(), 5)
            await client.close()
        finally:
            await broker.stop()

    run(go())


@pytest.mark.parametrize("client_of", [jpc.PulsarClient, ppc.PulsarClient],
                         ids=["jax", "port"])
def test_fakes_agree_on_auth_redirect_and_challenge(client_of):
    """Token auth, a lookup redirect and an AUTH_CHALLENGE on the port's
    fake, for either package's client; its CONNECTED carries a field
    outside the subset that both skip."""
    async def go():
        owner = PortFakeBroker(required_token="tok", challenge_after_connect=True)
        await owner.start()
        front = PortFakeBroker(required_token="tok", redirect_to=owner)
        await front.start()
        try:
            client = client_of(f"pulsar://127.0.0.1:{front.port}", auth_method="token",
                               auth_data=b"tok")
            prod = await client.create_producer("t")
            await prod.send(b"v")
            assert front.lookups == 1 and owner.topics["persistent://public/default/t"][0][0] == b"v"
            for _ in range(50):
                if owner.auth_responses:
                    break
                await asyncio.sleep(0.01)
            assert owner.auth_responses == [("token", b"tok")]
            await client.close()
            bad = client_of(f"pulsar://127.0.0.1:{owner.port}", auth_method="token",
                            auth_data=b"no")
            with pytest.raises(Exception, match="bad token"):
                await bad.create_producer("t")
            await bad.close()
        finally:
            await owner.stop()
            await front.stop()

    run(go())
