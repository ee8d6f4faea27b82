"""The port's ``python`` and ``chaos`` processors against the JAX
package's.

The python processor's user function receives the port's ``MessageBatch``
where JAX's receives a ``pyarrow.RecordBatch`` (the port has no pyarrow;
ROADMAP Queue C): a script written for one does not run on the other
unless it uses only what both offer. The rest is held to JAX's: the return
kinds and their batches, ``blocking``, ``module`` / ``function``, the
refusals. The chaos processor with one seed fails the same batch numbers in
both packages.
"""

from __future__ import annotations

import asyncio
import threading

import pytest

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.config import StreamConfig as JaxStreamConfig
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.errors import ProcessError as JaxProcessError
from arkflow_tpu.runtime import build_stream as jax_build_stream
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, build_component, ensure_plugins_loaded
from arkflow_tpu_torch.config import StreamConfig
from arkflow_tpu_torch.errors import ConfigError, ProcessError
from arkflow_tpu_torch.runtime.stream import build_stream

jax_plugins()
ensure_plugins_loaded()

#: threads the ``blocking`` test's functions ran on
RAN_ON: list = []


def double_x(batch):
    """A module function both packages can run: ``to_pylist`` is on both
    batch types."""
    rows = batch.to_pylist()
    RAN_ON.append(threading.current_thread().name)
    return [{"x": r["x"] * 2} for r in rows]


def _jbatch(data):
    return JaxBatch.from_pydict(data)


def _both(cfg: dict, data: dict):
    j = asyncio.run(jax_build("processor", cfg, JaxResource()).process(_jbatch(data)))
    p = asyncio.run(build_component("processor", cfg, Resource()).process(
        MessageBatch.from_pydict(data)))
    return [b.record_batch.to_pylist() for b in j], [b.to_pylist() for b in p], j, p


# -- python -------------------------------------------------------------------------

RETURNS = {
    "batch": "def process(batch):\n    return batch\n",
    "list_of_batches": "def process(batch):\n    return [batch, batch]\n",
    "dict_of_columns": "def process(batch):\n    return {'y': [1, 2], 'z': ['a', None]}\n",
    "list_of_row_dicts": "def process(batch):\n    return [{'a': 1, 'b': 'x'}, {'a': None}]\n",
    "nested_lists": "def process(batch):\n    return [[{'a': 1}], [], None, {'c': [True]}]\n",
    "none_drops": "def process(batch):\n    return None\n",
    "empty_list": "def process(batch):\n    return []\n",
    "coroutine": "async def process(batch):\n    return {'y': [3]}\n",
    "blocking_executor": None,
}


@pytest.mark.parametrize("kind", list(RETURNS), ids=list(RETURNS))
def test_python_return_kinds_match_jax(kind):
    cfg = {"type": "python", "script": RETURNS[kind]}
    if kind == "blocking_executor":
        cfg = {"type": "python", "module": __name__, "function": "double_x", "blocking": True}
        RAN_ON.clear()
    want, got, j, p = _both(cfg, {"x": [1, 2]})
    assert got == want
    assert [list(b.schema.values()) for b in p] == [[str(f.type) for f in b.record_batch.schema]
                                                    for b in j]
    if kind == "blocking_executor":
        assert len(RAN_ON) == 2 and threading.main_thread().name not in RAN_ON


def test_python_unsupported_return_type_as_jax():
    cfg = {"type": "python", "script": "def process(batch):\n    return 42\n"}
    with pytest.raises(JaxProcessError) as jerr:
        asyncio.run(jax_build("processor", cfg, JaxResource()).process(_jbatch({"x": [1]})))
    with pytest.raises(ProcessError) as perr:
        asyncio.run(build_component("processor", cfg, Resource()).process(
            MessageBatch.from_pydict({"x": [1]})))
    assert str(perr.value) == str(jerr.value) == "python processor returned unsupported type int"


def test_python_function_receives_a_message_batch_not_a_record_batch():
    """The one departure (ROADMAP Queue C): the batch type. JAX's
    ``tests/test_runtime.py`` script filters with ``pyarrow.compute`` on a
    ``RecordBatch``; the port's function gets a ``MessageBatch`` and filters
    with ``filter(mask)`` over a list of bools. Each script on its own
    package gives the same rows, and each package names its own type."""
    jax_script = ("import pyarrow.compute as pc\n"
                  "def process(batch):\n"
                  "    return batch.filter(pc.greater(batch.column('x'), 2))\n")
    port_script = ("def process(batch):\n"
                   "    return batch.filter([x > 2 for x in batch.to_pydict()['x']])\n")
    kind = "def process(batch):\n    return {'t': [type(batch).__name__]}\n"
    raw = {"input": {"type": "memory", "messages": ['{"x": 1}', '{"x": 5}'], "codec": "json"},
           "pipeline": {"thread_num": 1, "processors": [{"type": "python",
                                                          "script": jax_script}]},
           "output": {"type": "drop"}}
    from tests.test_runtime import CollectOutput as JaxCollect
    from tests.test_torch_stream import Collect

    jstream = jax_build_stream(JaxStreamConfig.from_mapping(raw))
    jsink = jstream.output = JaxCollect()
    asyncio.run(asyncio.wait_for(jstream.run(asyncio.Event()), timeout=10))
    raw["pipeline"]["processors"][0]["script"] = port_script
    stream = build_stream(StreamConfig.from_mapping(raw))
    sink = stream.output = Collect()
    asyncio.run(asyncio.wait_for(stream.run(asyncio.Event()), timeout=10))
    assert [v for b in sink.batches for v in b.to_pydict()["x"]] == [
        v for b in jsink.batches for v in b.column("x").to_pylist()] == [5]
    want, got, _, _ = _both({"type": "python", "script": kind}, {"x": [1]})
    assert (want, got) == ([[{"t": "RecordBatch"}]], [[{"t": "MessageBatch"}]])


@pytest.mark.parametrize("cfg", [
    {"type": "python"},
    {"type": "python", "script": "def process(b): return b", "module": "json"},
    {"type": "python", "script": "def process(b) return b"},
    {"type": "python", "script": "x = 1"},
    {"type": "python", "script": "def f(b): return b", "function": "g"},
    {"type": "python", "module": "no_such_module_anywhere"},
    {"type": "python", "module": "json", "function": "nope"},
], ids=["neither", "both", "syntax", "no_process", "missing_function", "no_module",
        "module_lacks_function"])
def test_python_refusals_as_jax(cfg):
    with pytest.raises(JaxConfigError) as jerr:
        jax_build("processor", cfg, JaxResource())
    with pytest.raises(ConfigError) as perr:
        build_component("processor", cfg, Resource())
    assert str(perr.value) == str(jerr.value)


def test_python_user_error_wrapped_as_jax():
    cfg = {"type": "python", "script": "def process(batch):\n    raise ValueError('bad row')\n"}
    with pytest.raises(JaxProcessError) as jerr:
        asyncio.run(jax_build("processor", cfg, JaxResource()).process(_jbatch({"x": [1]})))
    with pytest.raises(ProcessError) as perr:
        asyncio.run(build_component("processor", cfg, Resource()).process(
            MessageBatch.from_pydict({"x": [1]})))
    assert str(perr.value) == str(jerr.value) == "python processor failed: bad row"


# -- chaos --------------------------------------------------------------------------


def _failures(build, resource, cfg: dict, n: int) -> list:
    proc = build("processor", cfg, resource())

    async def go():
        out = []
        for i in range(n):
            batch = (JaxBatch if build is jax_build else MessageBatch).from_pydict({"i": [i]})
            try:
                await proc.process(batch)
                out.append(None)
            except Exception as e:  # the injected failure
                out.append(str(e))
        return out

    return asyncio.run(go())


@pytest.mark.parametrize("cfg", [
    {"type": "chaos", "fail_every": 3},
    {"type": "chaos", "fail_rate": 0.3, "seed": 7},
    {"type": "chaos", "fail_rate": 0.3, "seed": 8},
    {"type": "chaos", "fail_every": 4, "fail_rate": 0.5, "seed": 1},
    {"type": "chaos", "latency": "1ms"},
], ids=["every_3", "rate_seed_7", "rate_seed_8", "every_and_rate", "latency"])
def test_chaos_fails_the_same_batches_as_jax(cfg):
    want = _failures(jax_build, JaxResource, cfg, 40)
    assert _failures(build_component, Resource, cfg, 40) == want
    if "fail_rate" in cfg or "fail_every" in cfg:
        assert any(want)


def test_chaos_routes_to_error_output_as_jax():
    """``tests/test_runtime.py``: every third batch fails into
    ``error_output``; 4 of 6 reach the output in both packages."""
    raw = {"input": {"type": "memory", "messages": [f"m{i}" for i in range(6)]},
           "pipeline": {"thread_num": 1, "processors": [{"type": "chaos", "fail_every": 3}]},
           "output": {"type": "drop"}, "error_output": {"type": "drop"}}
    jstream = jax_build_stream(JaxStreamConfig.from_mapping(raw))
    asyncio.run(asyncio.wait_for(jstream.run(asyncio.Event()), timeout=10))
    stream = build_stream(StreamConfig.from_mapping(raw))
    asyncio.run(asyncio.wait_for(stream.run(asyncio.Event()), timeout=10))
    assert (stream.output.dropped_batches, stream.error_output.dropped_batches) == (
        jstream.output.dropped_batches, jstream.error_output.dropped_batches) == (4, 2)


@pytest.mark.parametrize("cfg", [
    {"type": "chaos", "fail_rate": 1.5},
    {"type": "chaos", "fail_every": -1},
    {"type": "chaos", "latency": "-5ms"},
], ids=["rate_above_one", "negative_every", "negative_latency"])
def test_chaos_refusals_as_jax(cfg):
    with pytest.raises(Exception) as jerr:
        jax_build("processor", cfg, JaxResource())
    with pytest.raises(Exception) as perr:
        build_component("processor", cfg, Resource())
    assert str(perr.value) == str(jerr.value)
    assert type(perr.value).__name__ == type(jerr.value).__name__
