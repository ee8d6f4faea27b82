"""The port's continuous-batching ``GenerationServer`` against the JAX
package's on the same weights (JAX-initialised, ``params_from_jax``) at
the JAX suites' TINY shape: greedy streams equal on ``TP_PROMPTS`` (five
prompts, tie-free under seed 3) over 2 slots, so they come in several
waves, with the gather path, the paged path (Pallas interpret on the JAX
side, K3's plain version here), chunked prefill and dispatch depth 2; then
page starvation, a crash, close mid-flight, the parity gate that raises,
and the refused options (``mesh``, and JAX's refusals of invalid
combinations)."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.tpu.serving import GenerationServer as JaxGenerationServer
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.models import paged_decode as pd
from arkflow_tpu_torch.tpu.serving import GenerationServer, KernelParityError

TINY = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, ffn=96, max_seq=64)
TP_PROMPTS = [[9], [55, 1, 2, 8, 13], [9, 4], [2, 77, 31, 5], [60, 61, 62]]
#: longer than the prefill chunk of 8 (three of them), so they admit in chunks
LONG_PROMPTS = [list(range(3, 25)), [9, 4], list(range(40, 55)), [7], list(range(3, 25))]


@pytest.fixture(scope="module")
def weights():
    fam = jax_get_model("decoder_lm")
    jcfg = fam.make_config(**TINY)
    jparams = fam.init(jax.random.PRNGKey(3), jcfg)
    return jparams, jcfg, params_from_jax(jax.device_get(jparams)), \
        get_model("decoder_lm").make_config(**TINY)


def _serve(cls, params, cfg, prompts, max_new, **kw):
    """Every prompt at once through a fresh 2-slot server; checks that every
    page is back and nothing is left in flight."""
    async def go():
        server = cls(params, cfg, slots=2, page_size=4, max_seq=40, **kw)
        free = len(server._free_pages)
        outs = await asyncio.gather(*[server.generate(p, max_new_tokens=max_new)
                                      for p in prompts])
        await server.close()
        assert len(server._free_pages) == free and not server._page_refs
        assert server._pipeline is None
        return outs, server

    return asyncio.run(go())


@pytest.fixture(scope="module")
def jax_streams(weights):
    jparams, jcfg, _, _ = weights
    return {
        "gather": _serve(JaxGenerationServer, jparams, jcfg, TP_PROMPTS, 6)[0],
        "paged": _serve(JaxGenerationServer, jparams, jcfg, TP_PROMPTS, 6,
                        decode_kernel="paged", kernel_interpret=True)[0],
        "chunked": _serve(JaxGenerationServer, jparams, jcfg, LONG_PROMPTS, 5,
                          prefill_chunk=8)[0],
    }


@pytest.mark.parametrize("ref,kw", [
    ("gather", {}),
    ("gather", {"dispatch_depth": 2}),
    ("paged", {"decode_kernel": "paged"}),
    ("paged", {"decode_kernel": "paged", "dispatch_depth": 2}),
], ids=["gather", "gather-depth2", "paged", "paged-depth2"])
def test_greedy_streams_match_jax(weights, jax_streams, ref, kw):
    _, _, params, cfg = weights
    got, server = _serve(GenerationServer, params, cfg, TP_PROMPTS, 6, **kw)
    assert got == jax_streams[ref]
    assert jax_streams["paged"] == jax_streams["gather"]
    assert server.prefill_steps == len(TP_PROMPTS) and server.decode_steps > 0
    assert server.tokens == sum(len(t) for t in got)
    assert len(server.ttft_samples) == len(TP_PROMPTS)
    assert (server.pipelined_dispatches > 0) == (kw.get("dispatch_depth", 1) == 2)
    if kw.get("decode_kernel") == "paged":
        assert server.parity_report["mismatches"] == 0
    else:
        assert server.parity_report is None


@pytest.mark.parametrize("kw", [{}, {"dispatch_depth": 2}, {"decode_kernel": "paged"}],
                         ids=["gather", "depth2", "paged"])
def test_chunked_prefill_streams_match_jax(weights, jax_streams, kw):
    _, _, params, cfg = weights
    got, server = _serve(GenerationServer, params, cfg, LONG_PROMPTS, 5, prefill_chunk=8, **kw)
    assert got == jax_streams["chunked"]
    # 22, 15 and 22 tokens in chunks of 8; the two short prompts go one-shot
    assert server.chunk_steps == 3 + 2 + 3 and server.prefill_steps == 2


def test_auto_resolves_to_gather_on_the_cpu(weights):
    _, _, params, cfg = weights
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40)
    assert server.decode_kernel == "gather" and server.device.type == "cpu"


def test_page_starvation_finishes_longest_without_corruption(weights):
    """When the pool runs dry, the longest sequence ends early and the
    survivor's tokens stay the solo stream's (no scratch-page corruption)."""
    jparams, jcfg, params, cfg = weights
    p1, p2 = [3, 17, 42, 7, 91, 12, 8, 2], [9, 4, 55, 1, 2, 3, 4, 5]

    async def solo():
        server = JaxGenerationServer(jparams, jcfg, slots=1, page_size=4, max_seq=32, eos_id=-1)
        out = await server.generate(p2, max_new_tokens=20)
        await server.close()
        return out

    ref2 = asyncio.run(solo())

    async def go():
        # 10 pages: both 8-token prompts fit (3 pages each) but cannot both
        # grow to 28 tokens (7 pages each)
        server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=32,
                                  num_pages=10, eos_id=-1)
        r1, r2 = await asyncio.gather(server.generate(p1, max_new_tokens=20),
                                      server.generate(p2, max_new_tokens=20))
        await server.close()
        return r1, r2, server

    r1, r2, server = asyncio.run(go())
    assert server.truncations >= 1
    assert min(len(r1), len(r2)) < 20 and max(len(r1), len(r2)) == 20
    assert r2 == ref2[:len(r2)]
    assert len(server._free_pages) == server.num_pages - 1


def test_serve_loop_crash_fails_the_request_and_returns_pages(weights):
    _, _, params, cfg = weights

    async def go():
        server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=32)
        total = server.num_pages - 1

        def boom(*a, **k):
            raise RuntimeError("injected device failure")

        server._decode = boom
        with pytest.raises(RuntimeError, match="injected"):
            await server.generate([3, 4, 5], max_new_tokens=4)
        assert len(server._free_pages) == total and not server._page_refs

    asyncio.run(go())


def test_close_mid_flight_fails_futures_instead_of_hanging(weights):
    _, _, params, cfg = weights

    async def go():
        server = GenerationServer(params, cfg, slots=1, page_size=4, max_seq=64, eos_id=-1)
        task = asyncio.create_task(server.generate([5, 6, 7], max_new_tokens=50))
        async def decoding():
            while server.decode_steps < 2:
                await asyncio.sleep(0.001)

        await asyncio.wait_for(decoding(), 5)  # admitted and decoding
        await server.close()
        with pytest.raises(ConfigError, match="closed"):
            await asyncio.wait_for(task, 5)
        with pytest.raises(ConfigError, match="closed"):
            await server.generate([1], max_new_tokens=1)

    asyncio.run(go())


def test_requests_are_validated(weights):
    _, _, params, cfg = weights

    async def go():
        server = GenerationServer(params, cfg, slots=1, page_size=4, max_seq=16)
        with pytest.raises(ConfigError, match="max_seq"):
            await server.generate(list(range(20)), max_new_tokens=8)
        assert await server.generate([], max_new_tokens=4) == []
        await server.close()

    asyncio.run(go())


def test_a_failed_parity_gate_raises_and_never_falls_back(weights, monkeypatch):
    _, _, params, cfg = weights
    monkeypatch.setattr(pd, "paged_flash_attention", lambda q, *a: torch.full_like(q, 3.0))
    with pytest.raises(KernelParityError, match="disagrees"):
        GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40, decode_kernel="paged")
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40,
                              decode_kernel="paged", kernel_parity_check=False)
    assert server.decode_kernel == "paged"


@pytest.mark.parametrize("kw", [
    {"temperature": 0.7, "speculative_tokens": 2},
    {"temperature": 0.5, "top_k": 5, "dispatch_depth": 2},
    {"speculative_tokens": 2, "dispatch_depth": 2},
    {"prefix_cache_pages": -1}, {"mesh": object()},
])
def test_unported_options_raise(weights, kw):
    """``mesh`` is not ported yet; sampling, speculation and the prefix
    cache are, and their invalid combinations raise the JAX server's own
    messages."""
    jparams, jcfg, params, cfg = weights
    if "mesh" in kw:
        with pytest.raises(ConfigError, match="not yet ported"):
            GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40, **kw)
        return
    with pytest.raises(Exception) as want:
        JaxGenerationServer(jparams, jcfg, slots=2, page_size=4, max_seq=40, **kw)
    with pytest.raises(ConfigError) as got:
        GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,match", [
    ({"dispatch_depth": 3}, "dispatch_depth"), ({"dispatch_depth": 0}, "dispatch_depth"),
    ({"decode_kernel": "dense"}, "decode_kernel"), ({"num_pages": 5}, "num_pages"),
    ({"prefill_chunk": -1}, "prefill_chunk"),
])
def test_invalid_options_raise(weights, kw, match):
    _, _, params, cfg = weights
    with pytest.raises(ConfigError, match=match):
        GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40, **kw)
