"""Switch MoE in the port's decoder (``num_experts > 1``) against the JAX
package's on the same weights (JAX-initialised, ``params_from_jax``) and the
same numpy inputs: ``_moe_mlp`` (``tests/test_models.py:456`` with ample
capacity, ``:490`` with overflow dropped, masked and unmasked, float32 and
bfloat16), the full forward, the paged prefill, chunk and decode steps with
idle lanes, the contiguous cache's prefill, decode and ``generate`` (padding
rows take expert capacity at decode, as in JAX), the incremental decode
against the full forward (``tests/test_paged_serving.py:103``), and the
MoE tree through ``params_from_jax``, ``quantize_for_serving`` and
``tree_digests``.

Tolerances: ``_moe_mlp`` at float32 within 1e-5 and its ``(lb, z)`` aux
stats within 1e-5; at bfloat16 within 1/64 (the expert products run in
bfloat16 in both packages). Model logits leave bf16 matmuls in both
packages: 1/64 plus one bf16 step (2^-7 of the magnitude). Greedy tokens
are held exactly. The weights and prompts are the JAX suites' ``TINY_MOE``
with seeds whose router top-2 gaps stay clear of ties on these inputs
(``_router_gap`` checks it where routing decides the outcome)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import decoder as jdec
from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.models import paged_decode as jpd
from arkflow_tpu.models import quantize as jquant
from arkflow_tpu.tpu import integrity as jintegrity
from arkflow_tpu_torch.convert import params_from_jax, params_to_numpy
from arkflow_tpu_torch.models import decoder as dec
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.models import paged_decode as pd
from arkflow_tpu_torch.models.quantize import quantize_for_serving
from arkflow_tpu_torch.tpu import integrity

#: ``tests/test_paged_serving.py:27-28``
TINY_MOE = dict(vocab_size=128, dim=32, layers=2, heads=2, kv_heads=1, ffn=48,
                max_seq=64, num_experts=4)
LOGIT_ATOL = 1.0 / 64
BF16_STEP = 2.0 ** -7
#: the one-layer MoE shapes of ``tests/test_models.py:456`` (capacity 8.0,
#: no drop) and ``:490`` (capacity 0.1, overflow dropped)
MLP_CASES = {"ample": (dict(vocab_size=64, dim=16, layers=1, heads=2, kv_heads=1, ffn=24,
                            max_seq=32, num_experts=4, capacity_factor=8.0), 0),
             "overflow": (dict(vocab_size=64, dim=16, layers=1, heads=2, kv_heads=1, ffn=24,
                               max_seq=32, num_experts=2, capacity_factor=0.1), 1)}


def _trees(overrides: dict, seed: int):
    fam = jax_get_model("decoder_lm")
    jcfg = fam.make_config(**overrides)
    jparams = fam.init(jax.random.PRNGKey(seed), jcfg)
    return (fam, jparams, jcfg, params_from_jax(jax.device_get(jparams)),
            get_model("decoder_lm").make_config(**overrides))


@pytest.fixture(scope="module")
def moe():
    return _trees(TINY_MOE, 2)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_logits(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=LOGIT_ATOL, rtol=BF16_STEP)


def _router_gap(jlp, y: np.ndarray) -> float:
    """The smallest top-2 gap of the router's probabilities over the tokens
    of ``y`` (float32): how far the inputs sit from a routing tie."""
    logits = y.reshape(-1, y.shape[-1]).astype(np.float32) @ np.asarray(jlp["router"]["w"],
                                                                          np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top = np.sort(probs, axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


def _layer0(jparams, params):
    return (jax.tree_util.tree_map(lambda x: x[0], jparams["layers"]),
            dec.layer_params(params["layers"], 0))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["ample", "overflow"])
def test_moe_mlp_matches_jax(case, masked, dtype):
    """``_moe_mlp`` and its aux stats against JAX's: float32 within 1e-5,
    bfloat16 within 1/64; with ample capacity every unmasked token is
    served, with capacity 1 per expert at most two are."""
    overrides, seed = MLP_CASES[case]
    _, jparams, jcfg, params, cfg = _trees(overrides, seed)
    jlp, lp = _layer0(jparams, params)
    rng = np.random.RandomState(seed)
    y = (rng.randn(2, 8, 16) * 0.2).astype(np.float32)
    mask = rng.rand(2, 8) > 0.3 if masked else None
    assert _router_gap(jlp, y) > 1e-3
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jout, (jlb, jz) = jdec._moe_mlp(jlp, jnp.asarray(y, jdt), jcfg,
                                    None if mask is None else jnp.asarray(mask))
    out, (lb, z) = dec._moe_mlp(lp, torch.from_numpy(y).to(tdt), cfg,
                                None if mask is None else torch.from_numpy(mask))
    assert out.dtype == tdt and out.shape == (2, 8, 16)
    atol = 1e-5 if dtype == "f32" else LOGIT_ATOL
    np.testing.assert_allclose(out.float().numpy(), _np(jout), atol=atol, rtol=0)
    np.testing.assert_allclose([float(lb), float(z)], [float(jlb), float(jz)], atol=1e-5, rtol=0)
    served = (out.float().abs().sum(-1) > 0).reshape(-1).numpy()
    want_served = np.ones(16, bool) if mask is None else mask.reshape(-1)
    if case == "ample":
        np.testing.assert_array_equal(served, want_served)
    else:  # capacity ceil(16 / 2 * 0.1) = 1 per expert
        assert served.sum() <= 2 and not (served & ~want_served).any()


def test_masked_tokens_take_no_capacity():
    """A case where counting the masked tokens WOULD overflow: row 0 (a
    padding row, masked) routes ahead of row 1 in every expert's queue.
    Unmasked, row 1's tokens past the capacity get zeros; masked, they are
    served -- as in JAX."""
    overrides = dict(MLP_CASES["overflow"][0], capacity_factor=1.0)
    _, jparams, jcfg, params, cfg = _trees(overrides, 1)
    jlp, lp = _layer0(jparams, params)
    y = (np.random.RandomState(0).randn(2, 8, 16) * 0.2).astype(np.float32)
    mask = np.zeros((2, 8), bool)
    mask[1] = True
    assert _router_gap(jlp, y) > 1e-3
    free, _ = dec._moe_mlp(lp, torch.from_numpy(y), cfg)
    held, _ = dec._moe_mlp(lp, torch.from_numpy(y), cfg, torch.from_numpy(mask))
    jheld, _ = jdec._moe_mlp(jlp, jnp.asarray(y), jcfg, jnp.asarray(mask))
    np.testing.assert_allclose(held.numpy(), _np(jheld), atol=1e-5, rtol=0)
    served_free = free[1].abs().sum(-1) > 0
    served_held = held[1].abs().sum(-1) > 0
    assert bool(served_held.all()) and not bool(served_free.all())
    assert float(held[0].abs().max()) == 0.0  # masked tokens get zeros
    capacity = math.ceil(16 / 2 * 1.0)
    assert int(served_free.sum()) < 8 <= 2 * capacity


def test_moe_init_draws_the_jax_layout():
    """JAX's MoE branch (``decoder.py:85-95``): no dense MLP; ``router`` a
    bias-free [dim, E] dense (float32 here: the router's logits are
    float32), ``experts`` [E, dim, ffn] / [E, ffn, dim] uniform in
    +-1/sqrt(dim), stacked per layer like every leaf; a meta-device init
    (the checkpoint restore's template) draws nothing."""
    fam = jax_get_model("decoder_lm")
    jcfg = fam.make_config(**TINY_MOE)
    jtree = jax.eval_shape(lambda: fam.init(jax.random.PRNGKey(0), jcfg))
    cfg = get_model("decoder_lm").make_config(**TINY_MOE)
    params = dec.init(torch.Generator().manual_seed(0), cfg)
    jshapes = {jax.tree_util.keystr(p): tuple(v.shape)
               for p, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tshapes = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
               jax.tree_util.tree_flatten_with_path(params_to_numpy(params))[0]}
    assert tshapes == jshapes
    layers = params["layers"]
    assert "w_gate" not in layers and layers["router"]["w"].dtype == torch.float32
    bound = 1 / np.sqrt(TINY_MOE["dim"])
    for name in ("w_gate", "w_up", "w_down"):
        w = layers["experts"][name]
        assert w.dtype == torch.bfloat16 and w.shape[:2] == (2, 4)
        assert float(w.float().abs().max()) <= bound and float(w.float().std()) > bound / 3
    # the experts of one layer are drawn apart, not copies
    assert not torch.equal(layers["experts"]["w_up"][0, 0], layers["experts"]["w_up"][0, 1])
    meta = dec.init(torch.Generator(), cfg, device="meta")
    assert meta["layers"]["experts"]["w_down"].shape == (2, 4, 48, 32)


def test_params_from_jax_carries_router_and_experts_bitwise(moe):
    fam, jparams, jcfg, params, cfg = moe
    host = jax.device_get(jparams)
    back = params_to_numpy(params)
    flat_j = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(host)[0]}
    flat_t = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert flat_j.keys() == flat_t.keys()
    assert "['layers']['experts']['w_gate']" in flat_t and "['layers']['router']['w']" in flat_t
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_t[k], np.asarray(v))


def test_forward_and_apply_match_jax(moe):
    """``forward``/``apply`` route unmasked (JAX ``:255-257``); logits at
    1/64 plus one bf16 step, the next token exactly on tie-free rows."""
    fam, jparams, jcfg, params, cfg = moe
    ids = np.random.RandomState(1).randint(1, 128, (3, 9)).astype(np.int32)
    jlogits = fam.extras["forward"](jparams, jcfg, jnp.asarray(ids))
    _close_logits(dec.forward(params, cfg, torch.from_numpy(ids)), jlogits)
    out = get_model("decoder_lm").apply(params, cfg, input_ids=torch.from_numpy(ids))
    jout = fam.apply(jparams, jcfg, input_ids=jnp.asarray(ids))
    top2 = np.sort(np.asarray(jlogits)[:, -1], axis=-1)
    tie_free = (top2[:, -1] - top2[:, -2]) > 0.05
    assert tie_free.any()
    np.testing.assert_array_equal(out["next_token"].numpy()[tie_free],
                                  np.asarray(jout["next_token"])[tie_free])


PAGE, NUM_PAGES = 4, 11
# non-contiguous tables; row 2 is an idle lane that owns no page
TABLE = np.asarray([[5, 2, 7, 9, 0, 0, 0, 0], [1, 3, 4, 6, 8, 0, 0, 0], [0] * 8], np.int32)


def _pools(seed: int):
    rng = np.random.RandomState(seed)
    shape = (TINY_MOE["layers"], NUM_PAGES, PAGE, TINY_MOE["kv_heads"],
             TINY_MOE["dim"] // TINY_MOE["heads"])
    k, v = (jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.5, jnp.bfloat16)
            for _ in range(2))
    as_torch = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
    return (k, v), (as_torch(k), as_torch(v))


def _check_pools(jpools, tpools):
    for jp, tp in zip(jpools, tpools):
        np.testing.assert_allclose(tp.float().numpy()[:, 1:], _np(jp)[:, 1:], atol=LOGIT_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("kernel", ["gather", "paged"])
def test_paged_steps_match_jax(moe, kernel):
    """The paged prefill (masked by ``positions < lengths``, JAX
    ``paged_decode.py:136``), a chunk at an offset with padded queries
    (``pos_valid``, ``:238``) and a decode step with an idle lane
    (``active``, ``:322``), on both attention paths (Pallas interpreted on
    the JAX side, K3's plain version here): logits at 1/64 plus one bf16
    step, the pools at 1/64."""
    fam, jparams, jcfg, params, cfg = moe
    ids = np.asarray([[3, 17, 42, 7, 91, 0, 0, 0], [5, 9, 1, 2, 3, 4, 5, 6], [0] * 8], np.int32)
    lens = np.asarray([5, 8, 0], np.int32)
    (jk, jv), (tk, tv) = _pools(0)
    jl, jk, jv = jpd.paged_prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens),
                                   jnp.asarray(TABLE), jk, jv, return_logits=True)
    tl, _, _ = pd.paged_prefill(params, cfg, torch.from_numpy(ids), torch.from_numpy(lens),
                                torch.from_numpy(TABLE), tk, tv, return_logits=True)
    _close_logits(tl[:2], jl[:2])
    _check_pools((jk, jv), (tk, tv))
    kw = dict(attention_kernel=kernel)
    jkw = dict(kw, kernel_interpret=kernel == "paged")
    cids = np.asarray([[8, 1, 44, 0], [2, 6, 0, 0], [0, 0, 0, 0]], np.int32)
    clen, coff = np.asarray([3, 2, 0], np.int32), lens
    jl, jk, jv = jpd.paged_prefill_chunk(jparams, jcfg, jnp.asarray(cids), jnp.asarray(coff),
                                         jnp.asarray(clen), jnp.asarray(TABLE), jk, jv,
                                         return_all=True, **jkw)
    tl, _, _ = pd.paged_prefill_chunk(params, cfg, torch.from_numpy(cids), torch.from_numpy(coff),
                                      torch.from_numpy(clen), torch.from_numpy(TABLE), tk, tv,
                                      return_all=True, **kw)
    assert bool(torch.isfinite(tl).all())  # padded queries stay finite
    for row, n in enumerate(clen[:2]):
        _close_logits(tl[row, :n], jl[row, :n])
    _check_pools((jk, jv), (tk, tv))
    lens2 = coff + clen
    tok = np.asarray([11, 12, 0], np.int32)
    act = np.asarray([True, True, False])
    jl, jk, jv = jpd.paged_decode_step(jparams, jcfg, jnp.asarray(tok), jnp.asarray(lens2),
                                       jnp.asarray(act), jnp.asarray(TABLE), jk, jv,
                                       return_logits=True, **jkw)
    tl, _, _ = pd.paged_decode_step(params, cfg, torch.from_numpy(tok), torch.from_numpy(lens2),
                                    torch.from_numpy(act), torch.from_numpy(TABLE), tk, tv,
                                    return_logits=True, **kw)
    _close_logits(tl[:2], jl[:2])
    _check_pools((jk, jv), (tk, tv))


def test_idle_lanes_take_no_capacity_in_the_decode_step():
    """An idle lane's garbage token never evicts an active lane: with a
    capacity of one slot per expert, the active lane's logits are the same
    whatever the idle lanes hold."""
    _, _, _, params, cfg = _trees({**TINY_MOE, "capacity_factor": 0.25}, 2)
    kp, vp = pd.init_page_pool(cfg, 4, PAGE)
    table = torch.tensor([[1, 2], [3, 0], [0, 0], [0, 0]], dtype=torch.int32)
    lens = torch.tensor([2, 1, 0, 0], dtype=torch.int32)
    act = torch.tensor([True, False, False, False])
    outs = []
    for idle in ([0, 0, 0], [7, 99, 5]):
        tok = torch.tensor([4] + idle, dtype=torch.int32)
        logits, _, _ = pd.paged_decode_step(params, cfg, tok, lens, act, table, kp.clone(),
                                            vp.clone(), return_logits=True)
        outs.append(logits[0])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("seed", [2, 5])
def test_moe_incremental_decode_matches_forward(seed):
    """``tests/test_paged_serving.py:103``: the cache path agrees with the
    full forward, in both packages; ``generate`` runs and equals JAX's."""
    fam, jparams, jcfg, params, cfg = _trees(TINY_MOE, seed)
    seq = [3, 17, 42, 7]
    full = dec.forward(params, cfg, torch.tensor([seq]))
    cache = dec.init_kv_cache(cfg, 1, 16)
    nxt, cache = dec.prefill(params, cfg, torch.tensor([seq], dtype=torch.int32), cache)
    assert int(nxt[0]) == int(full[0, -1].argmax())
    jfull = fam.extras["forward"](jparams, jcfg, jnp.asarray([seq], jnp.int32))
    assert int(nxt[0]) == int(jnp.argmax(jfull[0, -1]))
    ids, lens = torch.tensor([seq], dtype=torch.int32), torch.tensor([4], dtype=torch.int32)
    out, counts = dec.generate(params, cfg, ids, lens, max_new_tokens=4)
    jout, jcounts = fam.extras["generate"](jparams, jcfg, jnp.asarray([seq], jnp.int32),
                                           jnp.asarray([4], jnp.int32), max_new_tokens=4)
    assert counts.tolist() == np.asarray(jcounts).tolist() and int(counts[0]) <= 4
    assert out.tolist() == np.asarray(jout).tolist()


def test_contiguous_prefill_and_decode_match_jax(moe):
    """The contiguous cache: ``prefill`` masked by the prompt lengths (JAX
    ``:448, :470``), then ``decode_step`` UNMASKED (JAX ``:535``): the
    padded rows' and the padding row's tokens take expert capacity at
    every decode step. Logits at 1/64 plus one bf16 step."""
    fam, jparams, jcfg, params, cfg = moe
    ex = fam.extras
    ids = np.asarray([[5, 9, 3, 0], [7, 0, 0, 0], [1, 2, 3, 4], [1, 0, 0, 0]], np.int32)
    lens = np.asarray([3, 1, 4, 1], np.int32)
    jl, jc = ex["prefill"](jparams, jcfg, jnp.asarray(ids), ex["init_kv_cache"](jcfg, 4, 9),
                           lengths=jnp.asarray(lens), return_logits=True)
    tl, tc = dec.prefill(params, cfg, torch.from_numpy(ids), dec.init_kv_cache(cfg, 4, 9),
                         lengths=torch.from_numpy(lens), return_logits=True)
    _close_logits(tl, jl)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, jc = ex["decode_step"](jparams, jcfg, jnp.asarray(tok)[:, None], jc,
                                   return_logits=True)
        tl, tc = dec.decode_step(params, cfg, torch.from_numpy(tok)[:, None], tc,
                                 return_logits=True)
        _close_logits(tl, jl)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()


def test_decode_padding_rows_take_capacity_as_in_jax():
    """At a capacity of one slot per expert (2 tokens, E = 4, factor
    0.25), a batch's padding row, routed unmasked ahead of the real row,
    changes the real row's decode logits when its token changes -- in JAX
    and in the port alike: the port keeps JAX's batch semantics, padding
    included."""
    fam, jparams, jcfg, params, cfg = _trees({**TINY_MOE, "capacity_factor": 0.25}, 2)
    ex = fam.extras
    seq = [3, 17, 42, 7]

    def run(pad_token):
        ids = np.asarray([[pad_token, 0, 0, 0], seq], np.int32)
        lens = np.asarray([1, 4], np.int32)
        _, tc = dec.prefill(params, cfg, torch.from_numpy(ids), dec.init_kv_cache(cfg, 2, 6),
                            lengths=torch.from_numpy(lens), return_logits=True)
        _, jc = ex["prefill"](jparams, jcfg, jnp.asarray(ids), ex["init_kv_cache"](jcfg, 2, 6),
                              lengths=jnp.asarray(lens), return_logits=True)
        tok = np.asarray([pad_token, 11], np.int32)
        tl, _ = dec.decode_step(params, cfg, torch.from_numpy(tok)[:, None], tc,
                                return_logits=True)
        jl, _ = ex["decode_step"](jparams, jcfg, jnp.asarray(tok)[:, None], jc,
                                  return_logits=True)
        _close_logits(tl, jl)
        return tl[1].numpy(), _np(jl)[1]

    (got0, want0), (got1, want1) = run(0), run(1)
    assert not np.allclose(want0, want1, atol=LOGIT_ATOL)  # padding evicts in JAX ...
    assert not np.allclose(got0, got1, atol=LOGIT_ATOL)  # ... and in the port


def test_generate_with_padding_rows_matches_jax(moe):
    """``generate`` over a padded batch with ``n_real``: the padding rows
    start done but decode every step, unmasked, as in JAX; tokens and
    counts exact."""
    fam, jparams, jcfg, params, cfg = moe
    ids = np.asarray([[3, 17, 42, 7], [9, 4, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]], np.int32)
    lens = np.asarray([4, 2, 1, 1], np.int32)
    jout, jcounts = fam.extras["generate"](jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens),
                                           max_new_tokens=6, n_real=2)
    out, counts = dec.generate(params, cfg, torch.from_numpy(ids), torch.from_numpy(lens),
                               max_new_tokens=6, n_real=2)
    assert counts.tolist() == np.asarray(jcounts).tolist()
    assert out.tolist() == np.asarray(jout).tolist()


def test_quantize_and_digests_of_the_moe_tree_match_jax(moe):
    """``quantize_for_serving``: the router is a dense dict (``w``) and is
    quantized; the expert stacks have no ``w`` key and are cast to bf16
    (JAX ``quantize.py:79-84``). The count, the structure and every
    digest equal JAX's, and so do the float tree's digests."""
    fam, jparams, jcfg, params, cfg = moe
    jq, jn = jquant.quantize_for_serving(jparams)
    tq, tn = quantize_for_serving(params)
    assert tn == jn
    assert set(tq["layers"]["router"]) == {"w_q", "w_scale"}
    assert tq["layers"]["experts"]["w_gate"].dtype == torch.bfloat16
    assert jintegrity.tree_digests(jax.device_get(jq)) == integrity.tree_digests(tq)
    assert jintegrity.tree_digests(jax.device_get(jparams)) == integrity.tree_digests(params)


def test_routing_trace_holds_the_recorded_experts():
    """``RoutingTrace`` (the parity gate's held routing): a replayed call
    takes the recorded run's experts in place of its own argmax -- its
    output is the recorded routing's, the decisions that differ are
    counted, and masked tokens are not -- and a replay whose calls differ
    from the record raises."""
    overrides, seed = MLP_CASES["ample"]
    _, _, _, params, cfg = _trees(overrides, seed)
    lp = dec.layer_params(params["layers"], 0)
    y = torch.from_numpy((np.random.RandomState(3).randn(1, 16, 16) * 0.2).astype(np.float32))
    other = torch.from_numpy((np.random.RandomState(4).randn(1, 16, 16) * 0.2).astype(np.float32))
    trace = dec.RoutingTrace()
    with dec.holding_routing(trace):
        dec._moe_mlp(lp, y, cfg)
    assert len(trace.tops) == 1 and getattr(dec._routing, "trace", None) is None
    with dec.holding_routing(trace.replay()):
        held, _ = dec._moe_mlp(lp, other, cfg)
    own_top = dec.route(lp, other.reshape(16, 16))[2]
    assert trace.flips() == int((own_top != trace.tops[0]).sum()) > 0
    # the held output: ``other`` through the recorded experts
    _, probs, _ = dec.route(lp, other.reshape(16, 16))
    top = trace.tops[0]
    want, _ = dec.switch_experts(lp["experts"], other.reshape(16, 16), top,
                                 probs.gather(1, top[:, None])[:, 0],
                                 dec.expert_capacity(cfg, 16))
    assert torch.equal(held.reshape(16, 16), want)
    mask = torch.zeros(1, 16, dtype=torch.bool)
    with dec.holding_routing(trace.replay()):
        dec._moe_mlp(lp, other, cfg, mask)
    assert trace.flips() == int((own_top != trace.tops[0]).sum())  # masked: none counted
    with pytest.raises(RuntimeError, match="differ"):
        with dec.holding_routing(trace.replay()):
            dec._moe_mlp(lp, other[:, :8], cfg)
