"""The contiguous KV cache of the port's decoder (``init_kv_cache``,
``prefill``, ``decode_step``, ``generate``) and its CUDA-graph form
(``tpu/batch_generate.py``, here on the CPU's static buffers) against the
JAX package's functions on the same weights (``params_from_jax``) at the
JAX suites' ``TINY_DEC`` shape, with float32 and bfloat16 weights:
``tests/test_models.py`` ``:77`` (the cache against the full forward),
``:169`` (prefill against stepwise), ``:310`` (generate against
stepwise), ``:358`` (padding rows do not gate the early exit), and
``tests/test_paged_serving.py:40`` (paged against contiguous).

Both packages run the decoder's dense layers in bfloat16 whatever the
weights' dtype, so logits are held to the bf16 floor (1/64) at both; the
cache's first layer (K/V straight from the embedding) and every integer
(cursor, lengths, tokens, counts) are held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.models import decoder as dec
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.models.paged_decode import (init_page_pool, paged_decode_step,
                                                   paged_prefill)
from arkflow_tpu_torch.tpu.batch_generate import BatchGenerator

TINY_DEC = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, ffn=96, max_seq=64)
LOGIT_ATOL = 1.0 / 64


def _trees(seed: int, dtype: str):
    fam = jax_get_model("decoder_lm")
    jcfg = fam.make_config(**TINY_DEC)
    jparams = fam.init(jax.random.PRNGKey(seed), jcfg)
    if dtype == "bf16":
        jparams = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16) if x.ndim > 1 else x, jparams)
    return fam.extras, jparams, jcfg, params_from_jax(jax.device_get(jparams)), \
        get_model("decoder_lm").make_config(**TINY_DEC)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check_cache(jc, tc, upto: int):
    """Cursor, lengths and prompt width exactly; K/V of layer 0 exactly and
    of later layers at the bf16 floor, over the written positions."""
    assert int(tc["length"]) == int(jc["length"])
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
    assert int(tc["prompt_len"]) == int(jc["prompt_len"])
    for name in ("k", "v"):
        want, got = _np(jc[name])[:, :, :upto], tc[name].float().numpy()[:, :, :upto]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kv_cache_matches_full_forward_and_jax(dtype):
    """``test_models.py:77``: token by token through a fresh cache, the last
    step's argmax is the full forward's; every step's logits and the cache
    equal JAX's."""
    ex, jparams, jcfg, params, cfg = _trees(3, dtype)
    seq = [3, 17, 42, 7, 99]
    full = dec.forward(params, cfg, torch.tensor([seq]))
    jc, tc = ex["init_kv_cache"](jcfg, 1, 16), dec.init_kv_cache(cfg, 1, 16)
    preds = []
    for tok in seq:
        jl, jc = ex["decode_step"](jparams, jcfg, jnp.asarray([[tok]], jnp.int32), jc,
                                   return_logits=True)
        tl, tc2 = dec.decode_step(params, cfg, torch.tensor([[tok]], dtype=torch.int32), tc,
                                  return_logits=True)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
        preds.append(int(tl.argmax(-1)[0]))
    assert preds[-1] == int(full[0, -1].argmax())
    nxt, _ = dec.decode_step(params, cfg, torch.tensor([[seq[-1]]], dtype=torch.int32),
                             dec.init_kv_cache(cfg, 1, 16))
    assert nxt.dtype == torch.int32 and nxt.shape == (1,)
    _check_cache(jc, tc, len(seq))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_matches_stepwise_and_jax(dtype):
    """``test_models.py:169`` and its padded form: a right-padded batch
    reads each row's last true token; the cursor lands at T, the padding
    slots stay out of attention."""
    ex, jparams, jcfg, params, cfg = _trees(5, dtype)
    seq = [3, 17, 42, 7]
    tc = dec.init_kv_cache(cfg, 1, 16)
    for tok in seq:
        nxt_a, tc = dec.decode_step(params, cfg, torch.tensor([[tok]], dtype=torch.int32), tc)
    tb = dec.init_kv_cache(cfg, 1, 16)
    nxt_b, tb = dec.prefill(params, cfg, torch.tensor([seq], dtype=torch.int32), tb)
    assert int(nxt_a[0]) == int(nxt_b[0]) and int(tb["length"]) == 4
    np.testing.assert_allclose(tc["k"][:, :, :4].float().numpy(),
                               tb["k"][:, :, :4].float().numpy(), atol=1e-2)
    ids = np.asarray([[5, 9, 3, 0], [7, 0, 0, 0], [1, 2, 3, 4]], np.int32)
    lens = np.asarray([3, 1, 4], np.int32)
    jl, jc = ex["prefill"](jparams, jcfg, jnp.asarray(ids), ex["init_kv_cache"](jcfg, 3, 9),
                           lengths=jnp.asarray(lens), return_logits=True)
    tl, tc = dec.prefill(params, cfg, torch.from_numpy(ids), dec.init_kv_cache(cfg, 3, 9),
                         lengths=torch.from_numpy(lens), return_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    _check_cache(jc, tc, 4)
    # then decode steps over the padded block: RoPE at each row's length,
    # its padding slots masked, the generated block after the prompt width
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, jc = ex["decode_step"](jparams, jcfg, jnp.asarray(tok)[:, None], jc,
                                   return_logits=True)
        tl, tc = dec.decode_step(params, cfg, torch.from_numpy(tok)[:, None], tc,
                                 return_logits=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    _check_cache(jc, tc, 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_generate_matches_stepwise_and_jax(dtype):
    """``test_models.py:310``: ``generate`` equals a Python loop over
    prefill + decode_step with EOS, and JAX's jitted ``generate``."""
    ex, jparams, jcfg, params, cfg = _trees(7, dtype)
    prompts = np.asarray([[5, 9, 3, 0], [7, 0, 0, 0]], np.int32)
    lengths = np.asarray([3, 1], np.int32)
    max_new = 6
    tokens, counts = dec.generate(params, cfg, torch.from_numpy(prompts),
                                  torch.from_numpy(lengths), max_new, eos_id=2)
    cache = dec.init_kv_cache(cfg, 2, 4 + max_new)
    nxt, cache = dec.prefill(params, cfg, torch.from_numpy(prompts), cache,
                             lengths=torch.from_numpy(lengths))
    want, done = [[], []], [False, False]
    for _ in range(max_new):
        t = nxt.numpy()
        for i in range(2):
            if not done[i]:
                if t[i] == 2:
                    done[i] = True
                else:
                    want[i].append(int(t[i]))
        if all(done):
            break
        nxt, cache = dec.decode_step(params, cfg, nxt[:, None], cache)
    got = [tokens[i, : int(counts[i])].tolist() for i in range(2)]
    assert got == want
    jt, jn = jax.jit(lambda p, i, l: ex["generate"](p, jcfg, i, l, max_new_tokens=max_new,
                                                     eos_id=2))(
        jparams, jnp.asarray(prompts), jnp.asarray(lengths))
    assert tokens.tolist() == np.asarray(jt).tolist()
    assert counts.tolist() == np.asarray(jn).tolist()


def test_padding_rows_do_not_gate_early_exit():
    """``test_models.py:358``: 1 real row + 7 padding rows; padding emits
    nothing, the real row equals its padless run and JAX's, and an EOS on
    the real row ends the loop for the whole batch."""
    ex, jparams, jcfg, params, cfg = _trees(9, "f32")
    prompts = np.asarray([[5, 9, 0, 0]] + [[0, 0, 0, 0]] * 7, np.int32)
    lengths = np.asarray([2] + [1] * 7, np.int32)
    tokens, counts = dec.generate(params, cfg, torch.from_numpy(prompts),
                                  torch.from_numpy(lengths), 8, eos_id=2, n_real=1)
    assert counts[1:].sum() == 0 and not tokens[1:].any()
    t1, c1 = dec.generate(params, cfg, torch.from_numpy(prompts[:1]),
                          torch.from_numpy(lengths[:1]), 8, eos_id=2)
    assert tokens[0, : int(counts[0])].tolist() == t1[0, : int(c1[0])].tolist()
    # against JAX under seed 4: seed 9's real row meets an exact top-2 tie
    # (gap 0) at step 1, where the two packages may pick either token
    ex, jparams, jcfg, params, cfg = _trees(4, "f32")
    tokens, counts = dec.generate(params, cfg, torch.from_numpy(prompts),
                                  torch.from_numpy(lengths), 8, eos_id=2, n_real=1)
    jt, jn = ex["generate"](jparams, jcfg, jnp.asarray(prompts), jnp.asarray(lengths),
                            max_new_tokens=8, eos_id=2, n_real=jnp.asarray(1, jnp.int32))
    assert tokens.tolist() == np.asarray(jt).tolist() and counts.tolist() == np.asarray(jn).tolist()
    assert counts[1:].sum() == 0
    # the real row's 2nd token as EOS: the whole batch stops at step 1
    eos = int(tokens[0, 1])
    stopped, n = dec.generate(params, cfg, torch.from_numpy(prompts), torch.from_numpy(lengths),
                              8, eos_id=eos, n_real=1)
    assert n.tolist() == [1] + [0] * 7 and not stopped[:, 1:].any()


def test_paged_decode_matches_contiguous():
    """``tests/test_paged_serving.py:40``: paged prefill + decode through a
    scattered page table (the prompt spans two pages, decode crosses a
    boundary) gives the contiguous path's tokens."""
    _, _, _, params, cfg = _trees(0, "f32")
    prompt = [3, 17, 42, 7, 91]
    n = len(prompt)
    cache = dec.init_kv_cache(cfg, 1, 32)
    nxt, cache = dec.prefill(params, cfg, torch.tensor([prompt], dtype=torch.int32), cache)
    ref = [int(nxt[0])]
    for _ in range(5):
        nxt, cache = dec.decode_step(params, cfg, torch.tensor([[ref[-1]]], dtype=torch.int32),
                                     cache)
        ref.append(int(nxt[0]))
    kp, vp = init_page_pool(cfg, 9, 4)
    table = torch.tensor([[5, 2, 7, 0, 0, 0, 0, 0]], dtype=torch.int32)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    ids[0, :n] = torch.tensor(prompt)
    nxt, kp, vp = paged_prefill(params, cfg, ids, torch.tensor([n], dtype=torch.int32), table,
                                kp, vp)
    got = [int(nxt[0])]
    lengths = torch.tensor([n], dtype=torch.int32)
    for _ in range(5):
        nxt, kp, vp = paged_decode_step(params, cfg, torch.tensor([got[-1]], dtype=torch.int32),
                                        lengths, torch.tensor([True]), table, kp, vp)
        lengths += 1
        got.append(int(nxt[0]))
    assert got == ref


@pytest.mark.parametrize("sample", [dict(), dict(temperature=1.3, top_k=5)],
                         ids=["greedy", "sampled"])
def test_batch_generator_equals_generate(sample):
    """The graph form on its static buffers: tokens and counts equal
    ``generate`` on the same key (the same subkeys per step), batch padding
    included; an all-EOS exit runs at most one masked step more and never
    changes tokens or counts; the workspace and graphs are reused."""
    _, _, _, params, cfg = _trees(7, "f32")
    ids = np.asarray([[5, 9, 3, 0], [7, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.asarray([3, 1, 1, 1], np.int32)
    ref_t, ref_c = dec.generate(params, cfg, torch.from_numpy(ids), torch.from_numpy(lens), 6,
                                eos_id=-1, n_real=2, rng_key=dec.make_key(4), **sample)
    gen = BatchGenerator(params, cfg, max_new_tokens=6, eos_id=-1, **sample)
    tokens, counts, steps = gen.generate(ids, lens, 2, dec.make_key(4))
    assert tokens.tolist() == ref_t[:2].tolist() and counts.tolist() == ref_c[:2].tolist()
    assert steps == 5 and tokens.shape == (2, 6)
    # EOS = row 0's 3rd token; row 1 ends on its own EOS or at the budget
    eos = int(tokens[0, 2])
    gen = BatchGenerator(params, cfg, max_new_tokens=6, eos_id=eos, **sample)
    ref_t, ref_c = dec.generate(params, cfg, torch.from_numpy(ids), torch.from_numpy(lens), 6,
                                eos_id=eos, n_real=2, rng_key=dec.make_key(4), **sample)
    for _ in range(2):
        tokens, counts, steps = gen.generate(ids, lens, 2, dec.make_key(4))
        assert tokens.tolist() == ref_t[:2].tolist() and counts.tolist() == ref_c[:2].tolist()
    # the last row is done after loop step max(counts) (its EOS pick); the
    # host reads that one step late, so one masked step may follow
    last = int(counts.max())
    assert steps == (5 if last >= 6 else min(last + 1, 5))
    assert gen.steps == [steps, steps] and gen.generations == 2
    assert gen.captures == 2
    assert gen.replay_counts() == {("prefill", 4, 4): 1, ("decode", 4, 4): 2 * steps - 1}


def test_padded_rows_attend_their_padding_from_the_second_decode_as_jax_does():
    """The reference's mask is ``k < lengths`` with ``lengths`` advanced
    every step (JAX ``decode_step``), so a row shorter than the prompt
    width attends its first padding slot at the second decode step: its
    logits there depend on what the padding holds, in JAX as in the port,
    and the port's equal JAX's for either padding."""
    ex, jparams, jcfg, params, cfg = _trees(5, "f32")
    lens = np.asarray([3, 1, 4], np.int32)
    steps = {}
    for pad in (0, 77):
        ids = np.asarray([[5, 9, 3, pad], [7, pad, pad, pad], [1, 2, 3, 4]], np.int32)
        jl, jc = ex["prefill"](jparams, jcfg, jnp.asarray(ids), ex["init_kv_cache"](jcfg, 3, 9),
                               lengths=jnp.asarray(lens), return_logits=True)
        tl, tc = dec.prefill(params, cfg, torch.from_numpy(ids), dec.init_kv_cache(cfg, 3, 9),
                             lengths=torch.from_numpy(lens), return_logits=True)
        got = [tl.numpy()]
        for _ in range(2):
            tok = np.asarray([11, 11, 11], np.int32)
            jl, jc = ex["decode_step"](jparams, jcfg, jnp.asarray(tok)[:, None], jc,
                                       return_logits=True)
            tl, tc = dec.decode_step(params, cfg, torch.from_numpy(tok)[:, None], tc,
                                     return_logits=True)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
            got.append(tl.numpy())
        steps[pad] = got
    # prefill and the first decode step never see the padding; the second
    # does for the padded rows, never for the full-width one
    np.testing.assert_array_equal(steps[0][0], steps[77][0])
    np.testing.assert_array_equal(steps[0][1], steps[77][1])
    assert (np.abs(steps[0][2] - steps[77][2]).max(axis=-1)[:2] > 1e-3).all()
    np.testing.assert_array_equal(steps[0][2][2], steps[77][2][2])
