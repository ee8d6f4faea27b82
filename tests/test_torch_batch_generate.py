"""``gpu_generate`` in ``serving: batch`` (the default, as in JAX) on the
CPU, against the JAX package's ``tpu_generate`` batch mode on the same
weights (JAX's seed-0 tree, restored in the port through ``checkpoint``)
and texts: the same greedy ``generated`` column; bucket padding and
``max_batch``; sampling keyed per batch from ``seed + 1``; the
``BatchGenerateUnit`` swap and rollback; the ``integrity`` refusal with
JAX's words; and the self-healing keys, parsed and unused in batch mode as
in JAX."""

import asyncio
import json

import jax
import pytest
import torch

from arkflow_tpu.batch import MessageBatch as JaxMessageBatch
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build_component
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, ensure_plugins_loaded
from arkflow_tpu_torch.components.registry import build_component
from arkflow_tpu_torch.config import EngineConfig
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError, SwapError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.runtime import cli
from arkflow_tpu_torch.tpu import checkpoint
from arkflow_tpu_torch.tpu.compiled_step import tree_map
from arkflow_tpu_torch.tpu.swap import BatchGenerateUnit

ensure_plugins_loaded()
jax_plugins()

TINY = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, ffn=96, max_seq=64)
TEXTS = [b"sensor alpha reading", b"x", b"pressure spike on line four, check the valve",
         b"refund the late order", b"w1 w2 w3 w4 w5 w6 w7 w8 w9 w10 w11 w12"]
BASE = {"model": "decoder_lm", "model_config": TINY, "max_input": 16, "max_new_tokens": 5,
        "batch_buckets": [4, 8], "seq_buckets": [8, 16]}


@pytest.fixture(scope="module")
def jax_proc():
    return jax_build_component("processor", {"type": "tpu_generate", **BASE}, JaxResource())


@pytest.fixture(scope="module")
def ckpt(jax_proc, tmp_path_factory):
    """JAX's seed-0 tree as a port checkpoint."""
    path = str(tmp_path_factory.mktemp("ck") / "seed0")
    checkpoint.save(path, params_from_jax(jax.device_get(jax_proc.params)))
    return path


def _proc(**kw):
    return build_component("processor", {"type": "gpu_generate", **BASE, "device": "cpu", **kw},
                           Resource())


def _texts(out) -> list[str]:
    return [t.decode() for t in out[0].column("generated").to_pylist()]


def _run(proc, batches):
    async def go():
        await proc.connect()
        outs = [_texts(await proc.process(MessageBatch.new_binary(b))) for b in batches]
        await proc.close()
        return outs

    return asyncio.run(go())


def test_default_is_batch_mode_and_matches_jax(jax_proc, ckpt):
    """No ``serving`` key: batch mode, as JAX; the greedy column equals
    JAX's on batches of 1, 3 and 5 rows (buckets 4 and 8, seq buckets 8
    and 16)."""
    proc = _proc(checkpoint=ckpt)
    assert proc.server is None and proc.runner is None and proc.generator is not None

    async def jax_go(batch):
        out = await jax_proc.process(JaxMessageBatch.new_binary(batch))
        return out[0].column("generated").to_pylist()

    batches = [TEXTS[:1], TEXTS[:3], TEXTS]
    want = [asyncio.run(jax_go(b)) for b in batches]
    got = _run(proc, batches)
    assert got == want
    assert all(len(t.split()) <= 5 for row in got for t in row)
    assert proc.tokens == sum(len(t.split()) for row in got for t in row) > 0
    gen = proc.generator
    # captured at connect: prefill and decode per (batch bucket, seq bucket)
    assert gen.captures == 2 * 2 * 2 and gen.generations == 3
    assert set(gen._spaces) == {(4, 8), (4, 16), (8, 8), (8, 16)}
    assert all(0 <= s <= 4 for s in gen.steps)


def test_bucket_padding_and_max_batch():
    """Padding rows never reach the column; ``max_batch`` sets the default
    row grid (pow2 8..max_batch); a batch past the largest bucket raises
    JAX's error."""
    proc = _proc(batch_buckets=None, max_batch=8)
    assert proc.buckets.batch_buckets == (8,)
    assert _proc(batch_buckets=None).buckets.batch_buckets == (8, 16)
    batch = MessageBatch.new_binary(TEXTS[:3])

    async def go():
        out = await proc.process(batch)
        with pytest.raises(ValueError, match="batch 9 exceeds bucket 8"):
            await proc.process(MessageBatch.new_binary(TEXTS + TEXTS[:4]))
        return out

    out = asyncio.run(go())
    assert out[0].num_rows == 3 and set(proc.generator._spaces) == {(8, 16)}


def test_sampling_is_keyed_per_batch_from_seed_plus_one():
    """Sampled batches: one stream per seed, another for another seed; each
    batch splits the processor's key (two identical batches differ)."""
    def run(seed):
        proc = _proc(temperature=1.0, top_k=20, seed=seed)
        return _run(proc, [TEXTS[:3], TEXTS[:3]])

    a = run(0)
    assert a == run(0) and a[0] != a[1]
    assert run(1) != a


def test_swap_and_rollback_through_the_batch_unit(tmp_path):
    """A swap copies the seed-1 tree into the live tensors (their addresses
    and the captures kept) and the column equals a processor built on seed
    1; a crash after the flip rolls back, and the column is the old one."""
    old = _proc(swap={"canary": {"min_agreement": 0.0}})
    assert isinstance(old.swapper.units[0], BatchGenerateUnit)
    new_tree = get_model("decoder_lm").init(torch.Generator().manual_seed(1),
                                            get_model("decoder_lm").make_config(**TINY))
    ck = str(tmp_path / "seed1")
    checkpoint.save(ck, new_tree)
    ref_new = _run(_proc(checkpoint=ck), [TEXTS])[0]
    ptrs = [t.data_ptr() for t in _leaves(old.params)]

    async def go():
        await old.connect()
        before = _texts(await old.process(MessageBatch.new_binary(TEXTS)))
        captures = old.generator.captures
        rep = await old.swapper.swap(ck)
        after = _texts(await old.process(MessageBatch.new_binary(TEXTS)))
        assert rep["version"] == 1 and old.generator.captures == captures
        old.swapper.inject_swap_fault("swap_crash")
        with pytest.raises(SwapError):
            await old.swapper.swap(ck)
        again = _texts(await old.process(MessageBatch.new_binary(TEXTS)))
        await old.close()
        return before, after, again

    before, after, again = asyncio.run(go())
    assert after == ref_new and after != before and again == after
    assert [t.data_ptr() for t in _leaves(old.params)] == ptrs
    assert old.params is old.generator.params
    assert old.host_params is not None


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def test_probe_uses_a_fixed_key_and_leaves_the_serving_key():
    proc = _proc(temperature=1.0, swap={})
    unit = proc.swapper.units[0]
    key = proc._key
    asyncio.run(unit.probe())
    asyncio.run(unit.probe())
    assert proc._key == key and proc.generator.generations == 2


def test_integrity_refusal_has_jax_words():
    block = {"integrity": {"probe_interval": "5s"}}
    with pytest.raises(JaxConfigError) as want:
        jax_build_component("processor", {"type": "tpu_generate", **BASE, **block},
                            JaxResource())
    with pytest.raises(ConfigError) as got:
        _proc(**block)
    assert str(got.value) == str(want.value).replace("tpu_generate", "gpu_generate")


@pytest.mark.parametrize("patch,raises", [
    ({"step_deadline": "1ms", "step_deadline_first": "1ms",
      "health": {"probe_backoff": "10ms", "dead_after": 2}}, None),
    ({"step_deadline": "0s"}, None),
    ({"step_deadline": "-1s"}, "invalid duration"),
    ({"health": {"dead_after": "x"}}, "dead_after"),
], ids=["tiny-deadlines", "zero", "malformed", "bad-health"])
def test_core_keys_are_parsed_and_unused_in_batch_mode(patch, raises):
    """As JAX's ``_build``: the keys are parsed (a malformed duration or
    health block raises in both packages), and only the continuous server
    takes them, so a 1 ms or a 0 s deadline does not touch a batch run."""
    cfg = {"type": "tpu_generate", **BASE, **patch}
    if raises:
        with pytest.raises(Exception, match=raises):
            jax_build_component("processor", cfg, JaxResource())
        with pytest.raises(ConfigError, match=raises):
            _proc(**patch)
        return
    jax_build_component("processor", cfg, JaxResource())
    proc = _proc(**patch)
    assert proc.runner is None
    assert len(_run(proc, [TEXTS[:2]])[0]) == 2


def test_batch_keys_validate(tmp_path):
    cfg = {"streams": [{"input": {"type": "generate", "payload": "x", "count": 1},
                        "pipeline": {"processors": [{
                            "type": "gpu_generate", "model_config": TINY, "device": "cpu",
                            "batch_buckets": [2, 4], "max_batch": 4, "temperature": 0.5,
                            "top_k": 3, "checkpoint": "/ckpt"}]},
                        "output": {"type": "drop"}}]}
    assert not EngineConfig.from_mapping(cfg).validate_components()
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    assert cli.main(["--config", str(path), "--validate"]) == 0
