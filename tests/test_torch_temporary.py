"""The port's temporaries (``plugins/temporary/``), the stream's
``temporary`` key and the ``sql`` processor's bindings against the JAX
package's, on the same inputs.

The Redis temporary runs against JAX's Redis fake (``tests/test_connectors.py``)
and the port's (``tools/fake_brokers.py``), each package's on each; the
fakes are stopped with ``server.close()``.
"""

from __future__ import annotations

import asyncio
import json

import pytest

from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.config import StreamConfig as JaxStreamConfig
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.runtime import build_stream as jax_build_stream
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, build_component, ensure_plugins_loaded
from arkflow_tpu_torch.config import EngineConfig, StreamConfig
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.runtime import cli
from arkflow_tpu_torch.runtime.stream import build_stream
from arkflow_tpu_torch.tools.fake_brokers import FakeRedisServer as PortRedis
from tests.test_connectors import FakeRedisServer as JaxRedis
from tests.test_runtime import CollectOutput as JaxCollect
from tests.test_torch_stream import Collect

jax_plugins()
ensure_plugins_loaded()

ROWS = [{"dev": 1, "label": "pump"}, {"dev": 2, "label": "valve"}, {"dev": 3, "label": "x"},
        {"dev": 1, "label": "pump-b"}, {"dev": None, "label": "orphan"}]


def _jrows(batch) -> tuple:
    rb = batch.record_batch
    return [str(f.type) for f in rb.schema], rb.to_pylist()


def _prows(batch) -> tuple:
    return list(batch.schema.values()), batch.to_pylist()


def run_both(raw: dict) -> tuple[list, list]:
    """The stream through each package; the rows each wrote, metadata
    stripped."""
    jstream = jax_build_stream(JaxStreamConfig.from_mapping(raw))
    jsink = jstream.output = JaxCollect()
    asyncio.run(asyncio.wait_for(jstream.run(asyncio.Event()), timeout=10))
    stream = build_stream(StreamConfig.from_mapping(raw))
    sink = stream.output = Collect()
    asyncio.run(asyncio.wait_for(stream.run(asyncio.Event()), timeout=10))
    assert stream.errors == 0
    want = [r for b in jsink.batches for r in b.strip_metadata().record_batch.to_pylist()]
    got = [r for b in sink.batches for r in b.strip_metadata().to_pylist()]
    return want, got


# -- the memory temporary -------------------------------------------------------------


@pytest.mark.parametrize("keys", [[1, 2], [2, 1, 2], [3], [99], [None], [1, None], []],
                         ids=lambda k: repr(k))
def test_memory_temporary_rows_as_jax(keys):
    """The table's rows whose key is asked for, in the table's order with
    its duplicates; a null key matches the null row."""
    cfg = {"type": "memory", "key": "dev", "rows": ROWS}

    async def go(temp):
        await temp.connect()
        return await temp.get(keys)

    jout = asyncio.run(go(jax_build("temporary", cfg, JaxResource())))
    pout = asyncio.run(go(build_component("temporary", cfg, Resource())))
    assert _prows(pout) == _jrows(jout)


@pytest.mark.parametrize("cfg", [
    {"type": "memory", "key": "dev"},
    {"type": "memory", "rows": ROWS},
    {"type": "memory", "key": "dev", "rows": "nope"},
    {"type": "memory", "key": "id", "rows": ROWS},
    {"type": "redis", "mode": "scan"},
], ids=["no_rows", "no_key", "rows_not_a_list", "key_not_in_rows", "bad_mode"])
def test_temporary_refusals_as_jax(cfg):
    with pytest.raises(JaxConfigError) as jerr:
        jax_build("temporary", cfg, JaxResource())
    with pytest.raises(ConfigError) as perr:
        build_component("temporary", cfg, Resource())
    assert str(perr.value) == str(jerr.value)


# -- the stream's temporary key and the sql bindings ----------------------------------


def _enrich(query: str, messages: list, rows: list, binding: dict) -> dict:
    return {"input": {"type": "memory", "codec": "json", "messages": messages},
            "temporary": [{"name": "devices", "type": "memory", "key": "dev", "rows": rows}],
            "pipeline": {"thread_num": 1, "processors": [
                {"type": "sql", "query": query, "temporary": [binding]}]},
            "output": {"type": "drop"}}


def test_sql_temporary_enrichment_matches_jax():
    """``tests/test_runtime.py``'s enrichment: JOIN on the looked-up rows."""
    raw = _enrich("SELECT flow.dev, devices.label FROM flow JOIN devices "
                  "ON flow.dev = devices.dev", ['{"dev": 1}', '{"dev": 2}'],
                  [{"dev": 1, "label": "pump"}, {"dev": 2, "label": "valve"},
                   {"dev": 3, "label": "x"}], {"name": "devices", "key": "dev"})
    want, got = run_both(raw)
    assert got == want == [{"dev": 1, "label": "pump"}, {"dev": 2, "label": "valve"}]


def test_sql_binding_table_name_and_key_expression_match_jax():
    """``table`` renames the lookup, ``key`` is an expression over flow, and
    a LEFT JOIN keeps flow rows whose key the lookup lacks (nulls)."""
    raw = _enrich("SELECT flow.id, d.label FROM flow LEFT JOIN d ON flow.id + 1 = d.dev "
                  "ORDER BY flow.id",
                  [json.dumps({"id": i}) for i in range(4)], ROWS[:3],
                  {"name": "devices", "table": "d", "key": "id + 1"})
    want, got = run_both(raw)
    assert got == want and [r["label"] for r in got] == ["pump", "valve", "x", None]


@pytest.mark.parametrize("binding,sql_temps", [
    ({"name": "nope", "key": "dev"}, True),
    ({"name": "devices"}, True),
    ({"name": "devices", "key": "dev"}, False),
], ids=["unknown_temporary", "no_key", "no_stream_temporaries"])
def test_binding_refusals_as_jax(binding, sql_temps):
    raw = _enrich("SELECT * FROM flow", ['{"dev": 1}'], ROWS, binding)
    if not sql_temps:
        del raw["temporary"]
    with pytest.raises(JaxConfigError) as jerr:
        jax_build_stream(JaxStreamConfig.from_mapping(raw))
    with pytest.raises(ConfigError) as perr:
        build_stream(StreamConfig.from_mapping(raw))
    assert str(perr.value) == str(jerr.value)


def test_temporary_config_and_validate(tmp_path):
    """``temporary`` needs a ``name``; ``--validate`` checks each
    temporary's type and keys."""
    raw = _enrich("SELECT * FROM flow", ['{"dev": 1}'], ROWS, {"name": "devices", "key": "dev"})
    bad = json.loads(json.dumps(raw))
    del bad["temporary"][0]["name"]
    with pytest.raises(JaxConfigError) as jerr:
        JaxStreamConfig.from_mapping(bad)
    with pytest.raises(ConfigError) as perr:
        StreamConfig.from_mapping(bad)
    assert str(perr.value) == str(jerr.value)
    assert EngineConfig.from_mapping({"streams": [raw]}).validate_components() == []
    raw["temporary"][0]["type"] = "nosuch"
    assert EngineConfig.from_mapping({"streams": [raw]}).validate_components()
    raw["temporary"][0].update(type="redis", ttl=5)
    problems = EngineConfig.from_mapping({"streams": [raw]}).validate_components()
    assert problems and "not yet ported" in problems[0]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"streams": [raw]}))
    assert cli.main(["--config", str(path), "--validate"]) == 2


def test_temporaries_connect_and_close_with_the_stream():
    """Connected after the output, closed with the other components."""
    from arkflow_tpu_torch.components import Temporary

    class Spy(Temporary):
        def __init__(self):
            self.log = []

        async def connect(self):
            self.log.append("connect")

        async def get(self, keys):
            self.log.append(("get", list(keys)))
            return MessageBatch.from_pydict({"dev": [1], "label": ["pump"]})

        async def close(self):
            self.log.append("close")

    raw = _enrich("SELECT flow.dev, devices.label FROM flow JOIN devices "
                  "ON flow.dev = devices.dev", ['{"dev": 1}'], ROWS,
                  {"name": "devices", "key": "dev"})
    stream = build_stream(StreamConfig.from_mapping(raw))
    spy = Spy()
    stream.temporaries["devices"] = stream.pipeline.processors[0].temporaries[0].temporary = spy
    stream.output = Collect()
    asyncio.run(asyncio.wait_for(stream.run(asyncio.Event()), timeout=10))
    assert spy.log == ["connect", ("get", [1]), "close"]


# -- the Redis temporary, on both packages' fakes -------------------------------------


def _fill(srv) -> None:
    srv.kv[b"dev:1"] = b'{"dev": 1, "label": "pump"}'
    srv.kv[b"dev:2"] = b'{"dev": 2, "label": "valve"}'
    srv.kv[b"dev:3"] = b'{"dev": 3, "label": null}'
    srv.lists[b"dev:1"] = [b'{"dev": 1, "part": "a"}', b'{"dev": 1, "part": "b"}']
    srv.lists[b"dev:2"] = [b'{"dev": 2, "part": "c"}']


@pytest.mark.parametrize("fake", ["jax_fake", "port_fake"])
@pytest.mark.parametrize("mode,keys", [
    ("get", [1, 2, 99]),            # tests/test_connectors.py: MGET, an absent key
    ("get", [2, 1, 2, None, 3]),    # key order, duplicates once, a null key skipped
    ("list", [1, 2, 7]),            # LRANGE a key, in key order
    ("get", [99]),                  # nothing found: an empty batch
], ids=["mget", "order_dups_nulls", "list", "none_found"])
def test_redis_temporary_matches_jax(fake, mode, keys):
    async def go():
        srv = JaxRedis() if fake == "jax_fake" else PortRedis()
        await srv.start()
        _fill(srv)
        cfg = {"type": "redis", "url": f"redis://127.0.0.1:{srv.port}", "mode": mode,
               "key_prefix": "dev:", "codec": "json"}
        out = []
        try:
            for build, resource in ((jax_build, JaxResource), (build_component, Resource)):
                temp = build("temporary", cfg, resource())
                await temp.connect()
                out.append(await temp.get(keys))
                await temp.close()
        finally:
            srv.server.close()
        return out

    jout, pout = asyncio.run(go())
    assert _prows(pout) == _jrows(jout)


def test_redis_temporary_refuses_before_connect_as_jax():
    from arkflow_tpu.errors import ReadError as JaxReadError
    from arkflow_tpu_torch.errors import ReadError

    cfg = {"type": "redis", "url": "redis://127.0.0.1:1"}
    with pytest.raises(JaxReadError) as jerr:
        asyncio.run(jax_build("temporary", cfg, JaxResource()).get([1]))
    with pytest.raises(ReadError) as perr:
        asyncio.run(build_component("temporary", cfg, Resource()).get([1]))
    assert str(perr.value) == str(jerr.value)
