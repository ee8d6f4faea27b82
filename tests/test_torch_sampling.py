"""Sampling in the port (``decoder.select_token``, its keys, and the
sampled steps of ``GenerationServer``) against the JAX package's
semantics. JAX's PRNG stream cannot be reproduced, so sampled tokens are
never compared with JAX's one for one; what is held: ``temperature <= 0``
is JAX's argmax, ``top_k=1`` is greedy, every draw lies in JAX's top-k set
of the same logits, draw frequencies follow ``softmax(logits / T)``, one
key gives one stream and different keys different ones, and the server's
sampled streams are deterministic per seed (``tests/test_paged_serving.py``
``:496`` and ``:533``), equal graphed and eager, and with ``top_k=1``
equal to the greedy stream."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import decoder as jdec
from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.tpu.serving import GenerationServer as JaxGenerationServer
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import decoder as dec
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.tpu.serving import GenerationServer

TINY = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, ffn=96, max_seq=64)
TP_PROMPTS = [[9], [55, 1, 2, 8, 13], [9, 4], [2, 77, 31, 5], [60, 61, 62]]


def _trees(seed: int):
    fam = jax_get_model("decoder_lm")
    jcfg = fam.make_config(**TINY)
    jparams = fam.init(jax.random.PRNGKey(seed), jcfg)
    return jparams, jcfg, params_from_jax(jax.device_get(jparams)), \
        get_model("decoder_lm").make_config(**TINY)


def _logits(seed: int, rows: int = 16, vocab: int = 64) -> np.ndarray:
    return (np.random.RandomState(seed).randn(rows, vocab) * 2).astype(np.float32)


@pytest.mark.parametrize("temperature", [0.0, -1.0])
def test_non_positive_temperature_is_jax_argmax(temperature):
    logits = _logits(0)
    want = np.asarray(jdec.select_token(jnp.asarray(logits), None, temperature, 5))
    got = dec.select_token(torch.from_numpy(logits), None, temperature, 5)
    assert got.dtype == torch.int32 and got.numpy().tolist() == want.tolist()


def test_top_k_one_is_greedy():
    logits = torch.from_numpy(_logits(1))
    greedy = dec.select_token(logits)
    for seed in range(8):
        key = dec.split_key(dec.make_key(seed))[1]
        assert torch.equal(dec.select_token(logits, key, 1.5, 1), greedy)


@pytest.mark.parametrize("top_k", [2, 5, 64, 500])
def test_every_draw_lies_in_jax_top_k_set(top_k):
    """Including k past the vocabulary (clamped, as JAX clamps)."""
    logits = _logits(2)
    k = min(top_k, logits.shape[-1])
    kth = np.asarray(jax.lax.top_k(jnp.asarray(logits / 0.8), k)[0])[:, -1]
    scaled = logits / np.float32(0.8)
    seen = set()
    for seed in range(24):
        got = dec.select_token(torch.from_numpy(logits), dec.make_key(seed), 0.8, top_k).numpy()
        assert (scaled[np.arange(len(got)), got] >= kth).all()
        seen.update(zip(range(len(got)), got.tolist()))
    # the draws spread over the set, not only its argmax
    assert len(seen) > logits.shape[0]


def test_uniforms_stay_inside_the_open_interval():
    """The extreme hashes map strictly inside (0, 1), so the Gumbel noise is
    finite and a top-k-masked logit (-inf) stays -inf: no NaN can win the
    argmax."""
    h = torch.tensor([0, 1, 511, 512, 2 ** 31, 2 ** 32 - 512, 2 ** 32 - 1])
    u = dec.open_uniform(h)
    assert (u > 0).all() and (u < 1).all()
    noise = -torch.log(-torch.log(u))
    assert torch.isfinite(noise).all()
    assert torch.isneginf(torch.tensor(float("-inf")) + noise).all()


def test_frequencies_follow_the_tempered_softmax():
    """4000 draws at vocabulary 8, each a row of one step: every token's
    frequency within 5 sigma of ``softmax(l / T)``."""
    l8 = np.random.RandomState(3).randn(8).astype(np.float32)
    temperature = 0.9
    logits = torch.from_numpy(np.tile(l8, (4000, 1)))
    draws = dec.select_token(logits, dec.make_key(11), temperature).numpy()
    p = np.asarray(jax.nn.softmax(jnp.asarray(l8) / temperature))
    freq = np.bincount(draws, minlength=8) / 4000
    sigma = np.sqrt(p * (1 - p) / 4000)
    assert (np.abs(freq - p) <= 5 * sigma).all(), (freq, p)


def test_keys_seed_streams():
    """One key, one stream; other keys, other streams; ``split_key`` gives
    two keys unlike each other and the parent; a key draws the same on a
    tensor of its words."""
    logits = torch.from_numpy(_logits(4))
    a = dec.select_token(logits, dec.make_key(5), 1.0)
    assert torch.equal(a, dec.select_token(logits, dec.make_key(5), 1.0))
    assert torch.equal(a, dec.select_token(logits, torch.from_numpy(dec.key_words(dec.make_key(5))),
                                           1.0))
    others = [dec.select_token(logits, dec.make_key(s), 1.0) for s in range(6, 10)]
    assert all(not torch.equal(a, o) for o in others)
    key = dec.make_key(5)
    nxt, sub = dec.split_key(key)
    assert len({key, nxt, sub}) == 3
    with pytest.raises(ConfigError, match="needs a key"):
        dec.select_token(logits, None, 1.0)


def test_generate_sampling_temperature_and_topk():
    """``tests/test_paged_serving.py:496`` on the port's ``generate``:
    temperature 0 is greedy whatever the key; sampling is deterministic per
    key and varies across keys; ``top_k=1`` collapses back to greedy."""
    _, _, params, cfg = _trees(7)
    prompt, lens = torch.tensor([[3, 17, 42]]), torch.tensor([3])

    def gen(**kw):
        return dec.generate(params, cfg, prompt, lens, max_new_tokens=8, eos_id=-1, **kw)[0]

    greedy = gen()
    assert torch.equal(greedy, gen(temperature=0.0, rng_key=dec.make_key(1)))
    k1 = gen(temperature=1.5, rng_key=dec.make_key(1))
    assert torch.equal(k1, gen(temperature=1.5, rng_key=dec.make_key(1)))
    draws = [gen(temperature=1.5, rng_key=dec.make_key(k)) for k in range(5)]
    assert any(not torch.equal(draws[0], d) for d in draws[1:])
    assert torch.equal(gen(temperature=0.7, top_k=1, rng_key=dec.make_key(3)), greedy)


def _serve(server, prompts, max_new):
    async def go():
        outs = await asyncio.gather(*[server.generate(p, max_new_tokens=max_new)
                                      for p in prompts])
        await server.close()
        return outs

    return asyncio.run(go())


def test_server_sampling_deterministic_per_seed():
    """``tests/test_paged_serving.py:533`` on the port's server."""
    _, _, params, cfg = _trees(8)

    def run(seed):
        server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=32,
                                  temperature=1.2, top_k=8, seed=seed)
        return _serve(server, [[5, 9, 2]], 6)[0]

    a = run(42)
    assert a == run(42) and len(a) == 6
    assert any(run(seed) != a for seed in (43, 44, 45, 46))


@pytest.fixture(scope="module")
def seed3():
    return _trees(3)


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 4}, {"decode_kernel": "paged"}],
                         ids=["one-shot", "chunked", "paged"])
def test_server_sampled_streams_eager_equal_checked_and_top_k_one_greedy(seed3, kw):
    """Every sampled path (one-shot prefill, final chunk, decode): the
    static-buffer steps equal ``eager``, the in-graph top-k check finds no
    miss, and ``top_k=1`` gives the greedy server's streams exactly
    (seed 3 is tie-free on ``TP_PROMPTS``)."""
    jparams, jcfg, params, cfg = seed3
    base = dict(slots=2, page_size=4, max_seq=40, seed=9, **kw)
    sampled = [GenerationServer(params, cfg, temperature=0.8, top_k=5, check_top_k=True,
                                eager=eager, **base) for eager in (False, True)]
    a, b = (_serve(s, TP_PROMPTS, 6) for s in sampled)
    assert a == b and sampled[0].top_k_misses == 0 and sampled[0].tokens > 0
    want = _serve(JaxGenerationServer(jparams, jcfg, slots=2, page_size=4, max_seq=40),
                  TP_PROMPTS, 6)
    top1 = GenerationServer(params, cfg, temperature=1.5, top_k=1, check_top_k=True, **base)
    assert _serve(top1, TP_PROMPTS, 6) == want and top1.top_k_misses == 0


def test_top_k_check_counts_draws_outside_the_set(seed3, monkeypatch):
    """The check is live: a pick forced outside the top-k set is counted."""
    _, _, params, cfg = seed3
    from arkflow_tpu_torch.tpu import serving

    monkeypatch.setattr(serving, "select_token",
                        lambda logits, *a: logits.argmin(-1).to(torch.int32))
    server = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40, temperature=0.8,
                              top_k=3, check_top_k=True)
    outs = _serve(server, TP_PROMPTS[:2], 3)
    # every pick is a miss; an EOS pick ends its request without a token
    assert server.top_k_misses >= sum(len(o) for o in outs) > 0


@pytest.mark.parametrize("kw", [
    {"temperature": 0.8, "speculative_tokens": 2},
    {"temperature": 0.8, "dispatch_depth": 2},
], ids=["speculation", "depth2"])
def test_sampling_refusals_carry_jax_messages(seed3, kw):
    jparams, jcfg, params, cfg = seed3
    with pytest.raises(Exception) as want:
        JaxGenerationServer(jparams, jcfg, slots=2, page_size=4, max_seq=32, **kw)
    with pytest.raises(ConfigError) as got:
        GenerationServer(params, cfg, slots=2, page_size=4, max_seq=32, **kw)
    assert str(got.value) == str(want.value)
