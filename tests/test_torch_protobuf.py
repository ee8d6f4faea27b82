"""The port's protobuf codec and processors against the JAX package's.

The four cases of ``tests/test_protobuf.py`` run through both packages on
the same rows: payload bytes, decoded columns (types as pyarrow spells them,
``to_pylist()`` values) and config errors must agree. Where
``google.protobuf`` or ``protoc`` is missing (the card's machine has
neither), building the codec raises a ``ConfigError`` that names it.
"""

from __future__ import annotations

import asyncio
import sys

import pyarrow as pa
import pytest

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, build_component, ensure_plugins_loaded
from arkflow_tpu_torch.errors import ConfigError

jax_plugins()
ensure_plugins_loaded()

PROTO = """
syntax = "proto3";
package arktest;

message Reading {
  string sensor = 1;
  double value = 2;
  int64 ts = 3;
  repeated int32 tags = 4;
  Location loc = 5;
  float gain = 6;
  bytes raw = 7;
  uint64 seq = 8;
}

message Location {
  string site = 1;
}
"""

ROWS = {
    "sensor": ["t1", "t2"],
    "value": [21.5, 30.0],
    "ts": [100, 200],
    "tags": [[1, 2], []],
    "loc": [{"site": "fab-1"}, None],
    "gain": [0.1, 2.5],
    "raw": [b"\x00\x01", b""],
    "seq": [2 ** 63 + 5, 0],
}


def codec_cfg(message_type: str = "arktest.Reading", proto: str = PROTO) -> dict:
    return {"type": "protobuf", "proto_source": proto, "message_type": message_type}


def codecs(cfg: dict):
    return (jax_build("codec", cfg, JaxResource()), build_component("codec", cfg, Resource()))


def same_columns(jb: JaxBatch, pb: MessageBatch) -> None:
    assert pb.schema == {f.name: str(f.type) for f in jb.schema}
    assert pb.to_pydict() == jb.to_pydict()


def test_protobuf_codec_roundtrip():
    jc, pc = codecs(codec_cfg())
    jpay = jc.encode(JaxBatch(pa.RecordBatch.from_pydict(ROWS, schema=jc.schema)))
    ppay = pc.encode(pc.rows_to_batch([{k: v[i] for k, v in ROWS.items()} for i in range(2)]))
    assert ppay == jpay
    jdec = JaxBatch.concat([jc.decode(p) for p in jpay])
    pdec = MessageBatch.concat([pc.decode(p) for p in ppay])
    same_columns(jdec, pdec)
    assert pdec.to_pydict()["gain"][0] == pytest.approx(0.1, rel=1e-6)
    assert pdec.column("loc").to_pylist() == [{"site": "fab-1"}, None]
    same_columns(jc.decode_many(jpay), pc.decode_many(ppay))


def test_protobuf_processors_end_to_end():
    jc, pc = codecs(codec_cfg())
    src = {"sensor": ["a"], "value": [1.0], "ts": [5], "tags": [[7]], "loc": [{"site": "x"}],
           "gain": [1.0], "raw": [b"r"], "seq": [1]}
    payloads = pc.encode(pc.rows_to_batch([{k: v[0] for k, v in src.items()}]))
    assert payloads == jc.encode(JaxBatch(pa.RecordBatch.from_pydict(src, schema=jc.schema)))
    procs = {}
    for kind in ("protobuf_to_arrow", "arrow_to_protobuf"):
        cfg = {**codec_cfg(), "type": kind}
        procs[kind] = (jax_build("processor", cfg, JaxResource()),
                       build_component("processor", cfg, Resource()))

    async def go():
        jarrow = (await procs["protobuf_to_arrow"][0].process(
            JaxBatch.new_binary(payloads).with_source("kafka:t")))[0]
        parrow = (await procs["protobuf_to_arrow"][1].process(
            MessageBatch.new_binary(payloads).with_source("kafka:t")))[0]
        assert parrow.column_names == jarrow.column_names
        assert parrow.get_meta("__meta_source") == jarrow.get_meta("__meta_source") == "kafka:t"
        same_columns(jarrow.strip_metadata(), parrow.strip_metadata())
        jback = (await procs["arrow_to_protobuf"][0].process(jarrow))[0]
        pback = (await procs["arrow_to_protobuf"][1].process(parrow))[0]
        assert pback.to_binary() == jback.to_binary() == payloads
        assert pback.get_meta("__meta_source") == "kafka:t"

    asyncio.run(go())


@pytest.mark.parametrize("cfg", [
    {"type": "protobuf", "proto_source": PROTO},
    codec_cfg("nope.Missing"),
    codec_cfg("x.Y", proto="syntax = bogus!!"),
    {"type": "protobuf", "message_type": "arktest.Reading"},
    {"type": "protobuf", "message_type": "arktest.Reading", "proto_source": PROTO,
     "proto_file": "reading.proto"},
], ids=["no_message_type", "missing_type", "bad_proto", "no_source", "two_sources"])
def test_protobuf_codec_config_validation(cfg):
    with pytest.raises(JaxConfigError) as jerr:
        jax_build("codec", cfg, JaxResource())
    with pytest.raises(ConfigError) as perr:
        build_component("codec", cfg, Resource())
    assert str(perr.value).split(":")[0] == str(jerr.value).split(":")[0]


def test_protobuf_map_fields_roundtrip():
    proto = """
syntax = "proto3";
package arktest2;
message Inner { int32 n = 1; }
message Tagged {
  string name = 1;
  map<string, int32> labels = 2;
  map<string, Inner> inner = 3;
}
"""
    jc, pc = codecs(codec_cfg("arktest2.Tagged", proto))
    rows = [{"name": "a", "labels": {"x": 1, "y": 2}, "inner": {"k": {"n": 3}}},
            {"name": "b", "labels": {}, "inner": {}}]
    jpay = jc.encode(JaxBatch(pa.RecordBatch.from_pylist(rows, schema=jc.schema)))
    ppay = pc.encode(pc.rows_to_batch(rows))
    assert ppay == jpay
    jout, pout = jc.decode_many(jpay), pc.decode_many(ppay)
    same_columns(jout, pout)
    assert [dict(m) for m in pout.column("labels").to_pylist()] == [{"x": 1, "y": 2}, {}]
    # a decoded map's order follows the string hash (PYTHONHASHSEED), so the
    # re-encoded bytes are held to JAX's re-encode of its own decode
    assert pc.encode(pout) == jc.encode(jout)


@pytest.mark.parametrize("missing", ["google.protobuf", "protoc"])
def test_missing_protobuf_raises_a_config_error_naming_it(monkeypatch, missing):
    """As on the card: no fallback, a ``ConfigError`` naming what is missing."""
    if missing == "protoc":
        import shutil

        monkeypatch.setattr(shutil, "which", lambda name: None)
        match = "protoc binary not found"
    else:
        for mod in ("google.protobuf", "google.protobuf.descriptor_pb2",
                    "google.protobuf.descriptor_pool", "google.protobuf.message_factory",
                    "google.protobuf.descriptor"):
            monkeypatch.setitem(sys.modules, mod, None)
        match = "google.protobuf package is not installed"
    for family, cfg in (("codec", codec_cfg()),
                        ("processor", {**codec_cfg(), "type": "protobuf_to_arrow"}),
                        ("processor", {**codec_cfg(), "type": "arrow_to_protobuf"})):
        with pytest.raises(ConfigError, match=match):
            build_component(family, cfg, Resource())
