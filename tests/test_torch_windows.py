"""The port's window buffers against the JAX package's.

Each scenario (``tests/test_windows.py``'s cases without the SQL join, and a
few more) drives a JAX window and a port window through the same writes,
reads, acks and close; the emitted rows, their order and the source acks
each emission's ack fires must be equal. ``query`` (the join) raises "not
yet ported" at ``--validate`` and at build.
"""

from __future__ import annotations

import asyncio
import json

import pytest

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Ack as JaxAck
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.config import StreamConfig as JaxStreamConfig
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.plugins.buffer import window as jw
from arkflow_tpu.runtime import build_stream as jax_build_stream
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Resource, build_component, check_component
from arkflow_tpu_torch.components import ensure_plugins_loaded
from arkflow_tpu_torch.config import EngineConfig, StreamConfig
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.plugins.buffer import window as pw
from arkflow_tpu_torch.runtime import cli
from arkflow_tpu_torch.runtime.stream import build_stream
from tests.test_runtime import CollectOutput as JaxCollect
from tests.test_torch_stream import Collect

jax_plugins()
ensure_plugins_loaded()


class _JaxTagAck(JaxAck):
    def __init__(self, log: list, i: int):
        self.log, self.i = log, i

    async def ack(self) -> None:
        self.log.append(self.i)


class _TagAck(Ack):
    def __init__(self, log: list, i: int):
        self.log, self.i = log, i

    async def ack(self) -> None:
        self.log.append(self.i)


JAX = {"batch": JaxBatch, "ack": _JaxTagAck, "tumbling": jw.TumblingWindow,
       "sliding": jw.SlidingWindow, "session": jw.SessionWindow}
PORT = {"batch": MessageBatch, "ack": _TagAck, "tumbling": pw.TumblingWindow,
        "sliding": pw.SlidingWindow, "session": pw.SessionWindow}


def _rows(batch) -> list:
    return batch.to_pydict()["i"]


async def drive(pkg: dict, kind: str, kwargs: dict, ops: list) -> dict:
    """Run ``ops`` on a window of ``pkg``: ``("write", i[, source])``,
    ``("read",)``, ``("ack", k)`` (the k-th emission's ack), ``("close",)``,
    ``("sleep", s)``. Returns the emissions' rows and sources and the
    source acks fired, in order."""
    if pkg is PORT:  # ``inputs`` only names the join's tables, which the port has not
        kwargs = {k: v for k, v in kwargs.items() if k != "input_names"}
    win = pkg[kind](**kwargs)
    acked: list = []
    emitted: list = []
    acks: list = []
    for op in ops:
        if op[0] == "write":
            b = pkg["batch"].from_pydict({"i": [op[1]]})
            if len(op) > 2:
                b = b.with_source(op[2])
            await win.write(b, pkg["ack"](acked, op[1]))
        elif op[0] == "read":
            out = await asyncio.wait_for(win.read(), timeout=2)
            if out is None:
                emitted.append(None)
            else:
                emitted.append(_rows(out[0]))
                acks.append(out[1])
        elif op[0] == "ack":
            await acks[op[1]].ack()
        elif op[0] == "close":
            await win.close()
        elif op[0] == "sleep":
            await asyncio.sleep(op[1])
    await asyncio.sleep(0)  # a skipped window's acks run as a task
    return {"emitted": emitted, "acked": acked}


def _writes(n, source=None):
    return [("write", i) if source is None else ("write", i, source) for i in range(n)]


SCENARIOS = {
    "tumbling_interval": ("tumbling", {"interval_s": 0.05},
                          _writes(3) + [("read",), ("write", 9), ("read",), ("ack", 0),
                                        ("ack", 1)]),
    "tumbling_flush_on_close": ("tumbling", {"interval_s": 60.0},
                                [("write", 1), ("close",), ("read",), ("read",), ("ack", 0)]),
    "tumbling_two_sources": ("tumbling", {"interval_s": 0.03},
                             [("write", 0, "a"), ("write", 1, "b"), ("write", 2, "a"),
                              ("read",), ("ack", 0)]),
    "tumbling_inputs_without_query": ("tumbling", {"interval_s": 0.03, "input_names": ["a", "b"]},
                                      [("write", 0, "b"), ("write", 1, "a"), ("read",),
                                       ("ack", 0)]),
    "sliding_overlap_and_acks": ("sliding", {"window_size": 3, "slide_size": 2},
                                 _writes(4) + [("read",), ("read",), ("ack", 0), ("ack", 1)]),
    "sliding_close_partial": ("sliding", {"window_size": 4, "slide_size": 3},
                              _writes(10) + [("read",)] * 3 + [("close",), ("read",), ("read",)]
                              + [("ack", k) for k in range(4)]),
    "sliding_close_releases": ("sliding", {"window_size": 2, "slide_size": 2},
                               _writes(4) + [("read",), ("read",), ("ack", 0), ("ack", 1),
                                             ("close",), ("read",)]),
    "sliding_interval_emission": ("sliding", {"window_size": 10, "slide_size": 10,
                                              "interval_s": 0.04},
                                  _writes(3) + [("read",), ("ack", 0), ("close",), ("read",)]),
    "session_gap": ("session", {"gap_s": 0.05},
                    [("write", 1), ("write", 2), ("read",), ("write", 3), ("read",), ("ack", 1),
                     ("ack", 0)]),
    "session_close": ("session", {"gap_s": 60.0},
                      [("write", 1, "x"), ("write", 2, "y"), ("close",), ("read",), ("read",),
                       ("ack", 0)]),
}


@pytest.mark.parametrize("kind,kwargs,ops", list(SCENARIOS.values()), ids=list(SCENARIOS))
def test_window_matches_jax(kind, kwargs, ops):
    want = asyncio.run(drive(JAX, kind, kwargs, ops))
    got = asyncio.run(drive(PORT, kind, kwargs, ops))
    assert got == want


def test_session_window_waits_for_the_gap():
    async def go():
        w = pw.SessionWindow(0.05)
        await w.write(MessageBatch.from_pydict({"i": [1]}), _TagAck([], 1))
        t0 = asyncio.get_running_loop().time()
        batch, _ = await asyncio.wait_for(w.read(), timeout=2)
        return asyncio.get_running_loop().time() - t0, _rows(batch)

    elapsed, rows = asyncio.run(go())
    assert rows == [1] and elapsed >= 0.04


def test_sliding_window_timer_does_not_busy_spin():
    """Idle after a timer emission blocks, as the JAX window does."""

    async def go():
        w = pw.SlidingWindow(window_size=10, slide_size=10, interval_s=0.02)
        await w.write(MessageBatch.from_pydict({"i": [1]}), _TagAck([], 1))
        await asyncio.wait_for(w.read(), timeout=2)
        calls = {"n": 0}
        orig = w._take_due_locked

        def counted(*a, **k):
            calls["n"] += 1
            return orig(*a, **k)

        w._take_due_locked = counted
        reader = asyncio.create_task(w.read())
        await asyncio.sleep(0.3)
        reader.cancel()
        try:
            await reader
        except asyncio.CancelledError:
            pass
        return calls["n"]

    assert asyncio.run(go()) < 10


@pytest.mark.parametrize("cfg", [
    {"type": "tumbling_window"},
    {"type": "sliding_window"},
    {"type": "session_window"},
    {"type": "tumbling_window", "interval": "0s"},
    {"type": "sliding_window", "window_size": 0},
    {"type": "sliding_window", "window_size": 2, "interval": 0},
    {"type": "session_window", "gap": 0},
], ids=["tumbling_no_interval", "sliding_no_size", "session_no_gap", "tumbling_zero",
        "sliding_zero", "sliding_zero_interval", "session_zero"])
def test_window_config_validation(cfg):
    with pytest.raises(JaxConfigError) as jerr:
        jax_build("buffer", cfg, JaxResource())
    with pytest.raises(ConfigError) as perr:
        build_component("buffer", cfg, Resource())
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("kind,extra", [("tumbling_window", {"interval": "1s"}),
                                        ("sliding_window", {"window_size": 4}),
                                        ("session_window", {"gap": "50ms"})])
def test_window_query_is_not_yet_ported(tmp_path, kind, extra):
    cfg = {"type": kind, **extra, "query": "SELECT * FROM a JOIN b ON a.k = b.k",
           "inputs": ["a", "b"]}
    with pytest.raises(ConfigError, match="query .*not yet ported to arkflow_tpu_torch"):
        check_component("buffer", cfg)
    with pytest.raises(ConfigError, match="not yet ported to arkflow_tpu_torch"):
        build_component("buffer", cfg, Resource())
    engine = {"streams": [{"input": {"type": "memory", "messages": ["a"]}, "buffer": cfg,
                           "output": {"type": "drop"}}]}
    path = tmp_path / "w.json"
    path.write_text(json.dumps(engine))
    assert cli.main(["--config", str(path), "--validate"]) == 2
    engine["streams"][0]["buffer"] = {"type": kind, **extra, "inputs": ["a", "b"]}
    assert EngineConfig.from_mapping(engine).validate_components() == []


def test_window_stream_with_json_codec_matches_jax():
    """memory(codec: json) -> tumbling_window -> output, through each
    package's stream: the same rows, typed alike, every message once."""
    msgs = [json.dumps({"id": i, "v": i * 0.5, "tags": ["t"] * (i % 3 + 1)}) for i in range(12)]
    raw = {"input": {"type": "memory", "codec": "json", "messages": msgs},
           "buffer": {"type": "tumbling_window", "interval": "20ms"},
           "pipeline": {"thread_num": 1, "processors": []},
           "output": {"type": "drop"}}
    jstream = jax_build_stream(JaxStreamConfig.from_mapping(raw))
    jsink = jstream.output = JaxCollect()
    asyncio.run(asyncio.wait_for(jstream.run(asyncio.Event()), timeout=10))
    stream = build_stream(StreamConfig.from_mapping(raw))
    sink = stream.output = Collect()
    asyncio.run(asyncio.wait_for(stream.run(asyncio.Event()), timeout=10))
    want = [r for b in jsink.batches for r in b.strip_metadata().record_batch.to_pylist()]
    got = [r for b in sink.batches for r in b.strip_metadata().to_pylist()]
    assert got == want and [r["id"] for r in got] == list(range(12))
    assert stream.errors == 0
