"""Port parity for the packed path's buffering: ``MicroBatchCoalescer`` and
the ``memory`` buffer make the same emissions as the JAX package's on the
same writes (row and token-budget mode), acks compose over sources and
split shares, and the config checks raise where JAX's raise."""

import asyncio

import numpy as np
import pytest

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Ack as JaxAck
from arkflow_tpu.config import StreamConfig as JaxStreamConfig
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.plugins.buffer.memory import MemoryBuffer as JaxMemoryBuffer
from arkflow_tpu.tpu.bucketing import MicroBatchCoalescer as JaxCoalescer
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import (
    Ack,
    Resource,
    VecAck,
    build_component,
    check_component,
    ensure_plugins_loaded,
    split_ack,
)
from arkflow_tpu_torch.config import StreamConfig
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.plugins.buffer.memory import MemoryBuffer
from arkflow_tpu_torch.tpu.bucketing import MicroBatchCoalescer

ensure_plugins_loaded()

WORD = b"sensor reading nominal "


class RecAck(Ack):
    def __init__(self, log, name):
        self.log, self.name = log, name

    async def ack(self):
        self.log.append(("ack", self.name))

    async def nack(self):
        self.log.append(("nack", self.name))


class JaxRecAck(JaxAck):
    def __init__(self, log, name):
        self.log, self.name = log, name

    async def ack(self):
        self.log.append(("ack", self.name))

    async def nack(self):
        self.log.append(("nack", self.name))


def _writes(seed: int, n: int) -> list[list[bytes]]:
    """Ragged batches of ragged texts, empty batches and texts included."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        rows = int(rng.choice([0, 1, 3, 7, 16, 29]))
        out.append([WORD * int(rng.randint(0, 12)) + b"%d" % (i * 100 + r) for r in range(rows)])
    return out


def _drive(coalescer, batch_cls, ack_cls, writes, pop_every: int):
    """Add every write, pop full emissions every ``pop_every`` writes, then
    flush; returns each emission's payloads and tag ('exact'/'flush'), and
    the ack log after acking every emission."""
    log, emissions, acks = [], [], []
    for i, texts in enumerate(writes):
        coalescer.add(batch_cls.new_binary(texts), ack_cls(log, i))
        if i % pop_every == pop_every - 1:
            while (e := coalescer.pop_exact()) is not None:
                emissions.append(("exact", e[0].to_binary() if e[0].num_rows else []))
                acks.append(e[1])
    while (e := coalescer.pop_flush()) is not None:
        emissions.append(("flush", e[0].to_binary() if e[0].num_rows else []))
        acks.append(e[1])

    async def ack_all():
        for a in acks:
            await a.ack()

    asyncio.run(ack_all())
    return emissions, sorted(log, key=lambda x: x[1])


@pytest.mark.parametrize("seed,pop_every", [(0, 1), (1, 3), (2, 5)])
@pytest.mark.parametrize("mode", [
    {"batch_buckets": [8, 16, 32]},
    {"batch_buckets": [4, 8]},
    {"batch_buckets": [64], "token_budget": 200},
    {"batch_buckets": [64], "token_budget": 97, "max_row_tokens": 16},
    {"batch_buckets": [64], "token_budget": 64, "token_bytes": 4.0},
])
def test_coalescer_emissions_equal_jax(mode, seed, pop_every):
    writes = _writes(seed, 24)
    got, got_log = _drive(MicroBatchCoalescer(**mode), MessageBatch, RecAck, writes, pop_every)
    want, want_log = _drive(JaxCoalescer(**mode), JaxBatch, JaxRecAck, writes, pop_every)
    assert [len(p) for _, p in got] == [len(p) for _, p in want]
    assert got == want
    # every source acked exactly once, once all its shares acked
    assert got_log == want_log == [("ack", i) for i in range(len(writes))]


def test_token_coalescer_holds_until_budget_then_carves_rows():
    log = []
    c = MicroBatchCoalescer([64], token_budget=40)
    c.add(MessageBatch.new_binary([b"one two three"] * 3), RecAck(log, 0))  # 5 tokens a row
    assert c.pop_exact() is None and c.tokens == 15
    c.add(MessageBatch.new_binary([b"one two three"] * 4), RecAck(log, 1))
    c.add(MessageBatch.new_binary([b"one two three"] * 4), RecAck(log, 2))
    out, ack = c.pop_exact()
    assert out.num_rows == 8 and c.rows == 3 and c.tokens == 15
    asyncio.run(ack.ack())
    assert log == [("ack", 0), ("ack", 1)]  # batch 2 was split: its ack waits
    tail, tail_ack = c.pop_flush()
    assert tail.num_rows == 3
    asyncio.run(tail_ack.ack())
    assert log == [("ack", 0), ("ack", 1), ("ack", 2)]


def test_nacked_emission_nacks_exactly_its_sources():
    log = []
    c = MicroBatchCoalescer([4, 8])
    for i in range(3):  # 3 + 3 + 3 rows; target 8 splits batch 2
        c.add(MessageBatch.new_binary([b"r%d" % j for j in range(3)]), RecAck(log, i))
    first, first_ack = c.pop_exact()
    rest, rest_ack = c.pop_flush()
    assert (first.num_rows, rest.num_rows) == (8, 1)
    asyncio.run(first_ack.nack())
    assert log == [("nack", 0), ("nack", 1)]  # batch 2 waits for its tail share
    asyncio.run(rest_ack.ack())
    assert log == [("nack", 0), ("nack", 1), ("nack", 2)]  # any share nacked


def test_split_ack_shares_resolve_once():
    log = []
    parts = split_ack(RecAck(log, "s"), 3)
    asyncio.run(parts[0].ack())
    asyncio.run(parts[0].ack())  # a retried share does not count twice
    asyncio.run(parts[1].ack())
    assert log == []
    asyncio.run(parts[2].ack())
    assert log == [("ack", "s")]
    single = RecAck(log, "one")
    assert split_ack(single, 1) == [single]
    with pytest.raises(ValueError):
        split_ack(single, 0)
    asyncio.run(VecAck([RecAck(log, "a"), RecAck(log, "b")]).nack())
    assert log[-2:] == [("nack", "a"), ("nack", "b")]


async def _buffer_emissions(buf, batch_cls, ack_cls, writes, log):
    """Write everything, close, read until drained; row counts per emission."""
    for i, texts in enumerate(writes):
        await buf.write(batch_cls.new_binary(texts), ack_cls(log, i))
    await buf.close()
    out = []
    while (item := await buf.read()) is not None:
        out.append(item[0].num_rows)
        await item[1].ack()
    return out


@pytest.mark.parametrize("kwargs", [
    {"capacity": 200, "timeout_s": 5.0},
    {"capacity": 64, "timeout_s": 5.0, "coalesce_buckets": [8, 32], "coalesce_deadline_s": 5.0},
    {"capacity": 64, "timeout_s": 5.0, "coalesce_buckets": [64], "coalesce_deadline_s": 5.0,
     "token_budget": 300, "max_row_tokens": 16},
])
def test_memory_buffer_emissions_equal_jax(kwargs):
    writes = [w for w in _writes(7, 12) if w]
    got_log, want_log = [], []
    got = asyncio.run(_buffer_emissions(MemoryBuffer(**kwargs), MessageBatch, RecAck, writes,
                                        got_log))
    want = asyncio.run(_buffer_emissions(JaxMemoryBuffer(**kwargs), JaxBatch, JaxRecAck,
                                         writes, want_log))
    assert got == want and sum(got) == sum(len(w) for w in writes)
    assert sorted(got_log) == sorted(want_log) == sorted(("ack", i) for i in range(len(writes)))


def test_memory_buffer_deadline_flushes_a_partial_emission():
    async def go():
        log = []
        buf = MemoryBuffer(capacity=64, timeout_s=1.0, coalesce_buckets=[8],
                           coalesce_deadline_s=0.02)
        await buf.write(MessageBatch.new_binary([b"a"] * 3), RecAck(log, "a"))
        out = await asyncio.wait_for(buf.read(), timeout=5)
        assert out[0].num_rows == 3
        await out[1].ack()
        assert log == [("ack", "a")]

    asyncio.run(go())


def test_memory_buffer_backpressure_blocks_writes_at_the_bound():
    async def go():
        buf = MemoryBuffer(capacity=2, timeout_s=10.0)
        for _ in range(8):  # 8 rows = capacity x 4
            await buf.write(MessageBatch.new_binary([b"x"]), RecAck([], 0))
        blocked = asyncio.ensure_future(buf.write(MessageBatch.new_binary([b"y"]), RecAck([], 1)))
        await asyncio.sleep(0.05)
        assert not blocked.done()
        out = await buf.read()
        assert out[0].num_rows == 8
        await asyncio.wait_for(blocked, timeout=5)

    asyncio.run(go())


def _both_raise(port_fn, jax_fn, match=None):
    with pytest.raises(ConfigError, match=match):
        port_fn()
    with pytest.raises(JaxConfigError, match=match):
        jax_fn()


@pytest.mark.parametrize("kwargs,match", [
    ({"capacity": 64, "coalesce_buckets": [8]}, "deadline"),
    ({"capacity": 1, "timeout_s": 0.1, "coalesce_buckets": [8]}, "backpressure"),
    ({"capacity": 64, "timeout_s": 0.1, "coalesce_buckets": [8], "coalesce_deadline_s": 0.05,
      "token_budget": 64 * 4 * 16 + 1, "max_row_tokens": 16}, "attainable"),
    ({"capacity": 0}, "capacity"),
    ({"capacity": 8, "timeout_s": 0.1, "coalesce_buckets": [8], "token_budget": 0}, None),
    ({"capacity": 8, "timeout_s": 0.1, "coalesce_buckets": [8], "token_budget": 4,
      "token_bytes": -1.0}, None),
    ({"capacity": 8, "timeout_s": 0.1, "coalesce_buckets": [8], "token_budget": 4,
      "max_row_tokens": 0}, None),
])
def test_memory_buffer_checks_raise_like_jax(kwargs, match):
    _both_raise(lambda: MemoryBuffer(**kwargs), lambda: JaxMemoryBuffer(**kwargs), match)


@pytest.mark.parametrize("coalesce", [
    {"batch_buckets": [8], "deadline": "10ms", "token_budget": -1},
    {"batch_buckets": [8], "deadline": "10ms", "token_budget": True},
    {"batch_buckets": [8], "deadline": "10ms", "token_budget": 8, "token_bytes": 0},
    {"batch_buckets": [8], "deadline": "10ms", "token_budget": 8, "max_row_tokens": 0},
    {"deadline": "10ms"},
])
def test_buffer_builder_rejects_bad_knobs(coalesce):
    cfg = {"type": "memory", "capacity": 64, "coalesce": coalesce}
    with pytest.raises(ConfigError):
        check_component("buffer", cfg)
    with pytest.raises(ConfigError):
        build_component("buffer", cfg, Resource())
    with pytest.raises(ConfigError):
        build_component("buffer", {"type": "memory"}, Resource())


def _stream_map(buffer=None, packing=None, proc_type="gpu_inference"):
    proc = {"type": proc_type, "model": "bert_classifier"}
    if packing is not None:
        proc["packing"] = packing
    m = {"input": {"type": "generate", "payload": "a"},
         "pipeline": {"thread_num": 1, "processors": [proc]},
         "output": {"type": "drop"}}
    if buffer is not None:
        m["buffer"] = buffer
    return m


def _token_buffer(budget=256):
    return {"type": "memory", "capacity": 64,
            "coalesce": {"batch_buckets": [8], "deadline": "10ms", "token_budget": budget}}


@pytest.mark.parametrize("buffer,packing,match", [
    (_token_buffer(), False, "packing"),
    (_token_buffer(0), True, "token_budget"),
    (_token_buffer(True), True, "token_budget"),
    (_token_buffer("many"), True, "token_budget"),
    (None, "yes", "packing"),
])
def test_stream_config_cross_check_raises_like_jax(buffer, packing, match):
    _both_raise(lambda: StreamConfig.from_mapping(_stream_map(buffer, packing)),
                lambda: JaxStreamConfig.from_mapping(
                    _stream_map(buffer, packing, "tpu_inference")), match)


def test_stream_config_accepts_token_budget_with_packing():
    cfg = StreamConfig.from_mapping(_stream_map(_token_buffer(), True))
    assert cfg.buffer["coalesce"]["token_budget"] == 256
    m = _stream_map(_token_buffer())
    m["pipeline"]["processors"] = []  # nothing to cross-check
    StreamConfig.from_mapping(m)


def test_unported_buffer_features_raise():
    cfg = {"type": "memory", "capacity": 64,
           "coalesce": {"batch_buckets": [8], "deadline": "10ms", "dp": 2}}
    with pytest.raises(ConfigError, match="not yet ported"):
        check_component("buffer", cfg)
    with pytest.raises(ConfigError, match="not yet ported"):
        check_component("buffer", {"type": "memory", "capacity": 8, "retarget": True})
    # tenant lanes, once refused here, are ported: a tagged batch goes out
    # in its own lane (tests/test_torch_fairness.py holds them to JAX's)
    batch = MessageBatch.new_binary([b"a"]).with_column("__meta_ext_tenant",
                                                        np.array(["t1"]))

    async def lanes():
        buf = MemoryBuffer(capacity=8, timeout_s=0.01)
        await buf.write(batch, RecAck([], 0))
        await buf.write(MessageBatch.new_binary([b"b"]), RecAck([], 1))
        await buf.close()
        return [(await buf.read())[0].tenant() for _ in range(2)], await buf.read()

    assert asyncio.run(lanes()) == (["t1", None], None)
