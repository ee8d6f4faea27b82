"""The prefix cache and speculative decoding of the port's
``GenerationServer`` on the CPU, against the JAX package on the same
weights (``params_from_jax``): the scenarios of
``tests/test_paged_serving.py:218-400`` (speculative streams equal plain
greedy, the sampling refusal, speculation over chunked prefill, pages
reused and exact, eviction, the composition of both with chunks, nested
prefixes counted once), the streams of both on ``TP_PROMPTS`` (seed 3,
tie-free) against JAX's server, ``tests/test_hotswap.py:510-532`` (a swap
empties the cache), and an OOM reset and a deadline-miss rebuild emptying
it too; ``health_report()["prefix_cache"]`` carries JAX's keys."""

import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.tpu.serving import GenerationServer as JaxGenerationServer
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, ensure_plugins_loaded
from arkflow_tpu_torch.components.registry import build_component
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError, StepDeadlineExceeded
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.tpu import checkpoint
from arkflow_tpu_torch.tpu.health import HealthConfig
from arkflow_tpu_torch.tpu.serving import GenerationServer
from arkflow_tpu_torch.tpu.serving_core import is_oom_error

ensure_plugins_loaded()

TINY = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, ffn=96, max_seq=64)
TP_PROMPTS = [[9], [55, 1, 2, 8, 13], [9, 4], [2, 77, 31, 5], [60, 61, 62]]
#: TP_PROMPTS with a shared 8-token (two-page) head, twice: the second wave
#: hits the prefixes the first donated
SHARED = [[7, 3, 11, 5, 19, 23, 29, 31] + p for p in TP_PROMPTS]


def _trees(seed: int):
    fam = jax_get_model("decoder_lm")
    jcfg = fam.make_config(**TINY)
    jparams = fam.init(jax.random.PRNGKey(seed), jcfg)
    return fam, jparams, jcfg, params_from_jax(jax.device_get(jparams)), \
        get_model("decoder_lm").make_config(**TINY)


@pytest.fixture(scope="module")
def seed3():
    return _trees(3)


def _reference(fam, jparams, jcfg, prompt, max_new, eos_id=2):
    """``tests/test_paged_serving.py::_reference_generate``: JAX's
    contiguous-cache greedy generation of one prompt."""
    tokens, counts = fam.extras["generate"](
        jparams, jcfg, jnp.asarray([prompt], jnp.int32), jnp.asarray([len(prompt)], jnp.int32),
        max_new_tokens=max_new, eos_id=eos_id)
    return np.asarray(tokens)[0, : int(counts[0])].tolist()


def _run(server, prompts, max_new, *, sequential=False):
    async def go():
        if sequential:
            outs = [await server.generate(p, max_new_tokens=max_new) for p in prompts]
        else:
            outs = await asyncio.gather(*[server.generate(p, max_new_tokens=max_new)
                                          for p in prompts])
        await server.close()
        return outs

    return asyncio.run(go())


def test_speculative_decode_matches_greedy_exactly():
    """``test_paged_serving.py:218``: repetitive, arbitrary and one-token
    prompts; drafts are offered and accepted, fewer verify steps than
    tokens, and the streams are JAX's greedy ones."""
    fam, jparams, jcfg, params, cfg = _trees(6)
    prompts = [[5, 9] * 8, [3, 17, 42, 7, 91], [11]]
    refs = [_reference(fam, jparams, jcfg, p, 8) for p in prompts]
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40,
                              speculative_tokens=3)
    free = len(server._free_pages)
    assert _run(server, prompts, 8) == refs
    assert len(server._free_pages) == free
    assert server.spec_drafted > 0 and server.spec_accepted > 0
    assert server.verify_steps < server.tokens and server.decode_steps == 0
    assert server.device_steps["verify"] == server.verify_steps


def test_speculative_with_sampling_rejected():
    """``test_paged_serving.py:255``, with JAX's message."""
    _, jparams, jcfg, params, cfg = _trees(7)
    kw = dict(slots=2, page_size=4, max_seq=32, speculative_tokens=2, temperature=0.8)
    with pytest.raises(Exception) as want:
        JaxGenerationServer(jparams, jcfg, **kw)
    with pytest.raises(ConfigError, match="greedy") as got:
        GenerationServer(params, cfg, **kw)
    assert str(got.value) == str(want.value)


def test_speculative_composes_with_chunked_prefill():
    """``test_paged_serving.py:273``."""
    fam, jparams, jcfg, params, cfg = _trees(8)
    prompt = [4, 6] * 9
    ref = _reference(fam, jparams, jcfg, prompt, 6)
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40, prefill_chunk=4,
                              speculative_tokens=3)
    assert _run(server, [prompt], 6) == [ref]
    assert server.chunk_steps == 5 and server.verify_steps > 0


def test_prefix_cache_reuses_pages_and_stays_exact():
    """``test_paged_serving.py:304``: the second request aliases the
    first's three full pages, one hit, and both streams are JAX's."""
    fam, jparams, jcfg, params, cfg = _trees(9)
    common = list(range(3, 15))
    p1, p2 = common + [60, 61], common + [70, 71, 72]
    refs = [_reference(fam, jparams, jcfg, p, 5) for p in (p1, p2)]
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=32,
                              prefix_cache_pages=8)

    async def go():
        out1 = await server.generate(p1, max_new_tokens=5)
        assert server.prefix_hits == 0
        out2 = await server.generate(p2, max_new_tokens=5)
        await server.close()
        return [out1, out2]

    assert asyncio.run(go()) == refs
    assert server.prefix_hits == 1 and server.prefix_pages_shared == 3
    assert server._cache_held > 0 and all(c > 0 for c in server._page_refs.values())
    # the hit prefilled only its remainder, through one bucketed chunk
    assert server.chunk_steps == 1 and server.prefill_steps == 1


def test_prefix_cache_eviction_frees_pages():
    """``test_paged_serving.py:327``: a 2-page cap, three distinct 9-token
    prompts rotating the LRU."""
    _, _, _, params, cfg = _trees(10)
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=32,
                              prefix_cache_pages=2)
    total = server.num_pages - 1
    _run(server, [list(range(b + 1, b + 10)) for b in (0, 30, 60)], 3, sequential=True)
    assert server._cache_held <= 2 and server.prefix_evictions > 0
    held = sum(len(v) for v in server._prefix_cache.values())
    assert held == server._cache_held
    assert len(server._free_pages) + held == total


def test_prefix_cache_composes_with_speculation_and_chunks():
    """``test_paged_serving.py:350``."""
    fam, jparams, jcfg, params, cfg = _trees(11)
    common = [5, 9] * 6
    p1, p2 = common + [33], common + [44, 45]
    refs = [_reference(fam, jparams, jcfg, p, 6) for p in (p1, p2)]
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40,
                              prefix_cache_pages=8, prefill_chunk=4, speculative_tokens=3)
    assert _run(server, [p1, p2], 6, sequential=True) == refs
    assert server.prefix_hits >= 1


def test_prefix_cache_counts_distinct_pages_for_nested_prefixes():
    """``test_paged_serving.py:380``: a nested prefix shares pages with the
    longer entry; capacity counts physical pages once."""
    _, _, _, params, cfg = _trees(13)
    common = list(range(3, 11))
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=32,
                              prefix_cache_pages=8)
    _run(server, [common + [50], common + [51, 52, 53, 54, 55]], 3, sequential=True)
    assert len(server._prefix_cache) == 2
    assert sum(len(v) for v in server._prefix_cache.values()) == 5
    assert server._cache_held == 3


@pytest.mark.parametrize("kw", [
    {"speculative_tokens": 3},
    {"prefix_cache_pages": 16},
    {"prefix_cache_pages": 16, "speculative_tokens": 2, "prefill_chunk": 4},
    {"prefix_cache_pages": 16, "decode_kernel": "paged", "speculative_tokens": 3},
], ids=["spec", "prefix", "prefix-spec-chunk", "prefix-spec-paged"])
def test_streams_match_jax_on_tp_prompts(seed3, kw):
    """``SHARED`` (TP_PROMPTS behind one two-page head) in two waves
    through 2 slots: the port's streams (with ``paged``, K3's plain version
    over pages two slots share) equal the JAX server's with the same
    features on its gather path, and plain greedy; the second wave hits
    the cache."""
    _, jparams, jcfg, params, cfg = seed3
    jkw = {k: v for k, v in kw.items() if k != "decode_kernel"}
    prompts = SHARED + SHARED
    base = dict(slots=2, page_size=4, max_seq=40)
    want = _run(JaxGenerationServer(jparams, jcfg, **base, **jkw), prompts, 6, sequential=True)
    assert want == _run(JaxGenerationServer(jparams, jcfg, **base), prompts, 6, sequential=True)
    server = GenerationServer(params, cfg, **base, **kw)
    assert _run(server, prompts, 6, sequential=True) == want
    if kw.get("prefix_cache_pages"):
        assert server.prefix_hits >= len(SHARED)
    if kw.get("speculative_tokens"):
        assert server.verify_steps > 0 and server.spec_drafted > 0


def test_warmup_captures_verify_and_every_bucket_chunk(seed3):
    """Speculative servers step through ``("verify", k, kernel)`` only; with
    the prefix cache and no chunking a hit's remainder runs as one chunk of
    its prompt bucket, so warmup takes every bucket's chunk key."""
    _, _, _, params, cfg = seed3
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40,
                              prompt_buckets=[8, 16], speculative_tokens=3,
                              prefix_cache_pages=8)
    assert server.warmup() == len(server._compiled.keys())
    assert set(server._compiled.keys()) == {
        ("verify", 4, "gather"), ("chunk", 8, "gather"), ("chunk", 16, "gather"),
        ("chunk", 40, "gather"), ("prefill", 8), ("prefill", 16), ("prefill", 40)}


def test_health_report_prefix_cache_matches_jax(seed3):
    _, jparams, jcfg, params, cfg = seed3
    kw = dict(slots=2, page_size=4, max_seq=40, prefix_cache_pages=16)

    async def go(server):
        for p in SHARED[:3] + SHARED[:1]:
            await server.generate(p, max_new_tokens=3)
        rep = server.health_report()
        await server.close()
        return rep["prefix_cache"]

    want = asyncio.run(go(JaxGenerationServer(jparams, jcfg, **kw)))
    got = asyncio.run(go(GenerationServer(params, cfg, **kw)))
    assert got == want and got["entries"] > 0 and got["capacity_pages"] == 16


def test_oom_reset_empties_the_prefix_cache(seed3):
    """An OOM zeroes the pools in place: the cache and its refs go with the
    ledger, and the next requests are served exactly from a cold cache."""
    _, _, _, params, cfg = seed3
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40,
                              prefix_cache_pages=16,
                              health_config=HealthConfig(probe_backoff_s=0.05))
    want = _run(GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40), SHARED, 6)

    async def go():
        for p in SHARED:
            await server.generate(p, max_new_tokens=6)
        assert server._prefix_cache and server._cache_held > 0
        server.inject_step_fault("oom")
        with pytest.raises(Exception) as err:
            await server.generate(SHARED[1], max_new_tokens=6)
        assert is_oom_error(err.value)
        assert not server._prefix_cache and not server._cache_pages
        assert not server._prefix_lengths and not server._page_refs
        assert len(server._free_pages) == server.num_pages - 1
        assert not server.k_pages.any()
        assert server.health_report()["prefix_cache"]["entries"] == 0
        outs = [await server.generate(p, max_new_tokens=6) for p in SHARED]
        await server.close()
        return outs

    assert asyncio.run(go()) == want


def test_deadline_rebuild_empties_the_prefix_cache(seed3):
    """A miss renews the pools: the cache is flushed with the old ones, and
    the rebuilt server serves exactly."""
    _, _, _, params, cfg = seed3
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40,
                              prefix_cache_pages=16, step_deadline_s=1.0,
                              step_deadline_first_s=60.0,
                              health_config=HealthConfig(probe_backoff_s=0.05))
    server.warmup()
    want = _run(GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40), SHARED, 6)

    async def go():
        for p in SHARED:
            await server.generate(p, max_new_tokens=6)
        assert server._prefix_cache
        old_k = server.k_pages
        server.inject_step_fault("hang", 1.5)
        with pytest.raises(StepDeadlineExceeded):
            await server.generate(SHARED[2], max_new_tokens=6)
        assert server.k_pages is not old_k and server.pool_renewals == 1
        assert not server._prefix_cache and not server._cache_pages and not server._page_refs
        end = time.monotonic() + 10
        while server.core.zombies and time.monotonic() < end:
            await asyncio.sleep(0.02)
        outs = [await server.generate(p, max_new_tokens=6) for p in SHARED]
        await server.close()
        return outs

    assert asyncio.run(go()) == want
    assert server.core.rebuilds == 1


def test_swap_drains_and_empties_the_prefix_cache(tmp_path):
    """``tests/test_hotswap.py:510``: a finished prompt donates its pages;
    the swap resets the pools and flushes the cache; the same weights give
    the same text after it."""
    proc = build_component("processor", {
        "type": "gpu_generate", "model": "decoder_lm",
        "model_config": dict(vocab_size=128, dim=16, layers=1, heads=2, kv_heads=2, ffn=32,
                             max_seq=64),
        "max_input": 16, "max_new_tokens": 4, "batch_buckets": [2], "seq_buckets": [16],
        "serving": "continuous", "slots": 2, "page_size": 4, "prefix_cache_pages": 8,
        "device": "cpu"}, Resource())
    srv = proc.server
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, proc.params)
    batch = MessageBatch.new_binary([b"repeated prompt text goes here"])

    async def go():
        before = await proc.process(batch)
        await proc.process(batch)
        assert len(srv._prefix_cache) > 0 and srv.prefix_hits == 1
        rep = await proc.swapper.swap(ck)
        assert rep["version"] == 1
        assert len(srv._prefix_cache) == 0 and not srv._cache_pages
        assert len(srv._free_pages) == srv.num_pages - 1
        assert not srv._draining
        after = await proc.process(batch)
        await proc.close()
        return before, after

    before, after = asyncio.run(go())
    assert before[0].column("generated").to_pylist() == after[0].column("generated").to_pylist()
