"""Switch MoE through the port's serving paths on the CPU, against the JAX
package on the same weights (``params_from_jax``) at the JAX suites'
``TINY_MOE``: the continuous ``GenerationServer`` (plain, speculative, the
prefix cache; each graph key fixing its own expert capacity), the init
parity gate, a hot swap to another MoE tree, the bitflip leaf, batch mode's
``BatchGenerator`` over a padded bucket against JAX's ``generate``, and the
depth-2 refusal with JAX's message (``tests/test_paged_kernel.py:390-395``;
ROADMAP Queue C 1).

Greedy streams against JAX's are held exactly: at this width (dim 32) the
logits are bf16 values whose top-2 gaps are often 0 or one bf16 step, and
both packages compute the same bf16 logits here, so they break even exact
ties alike (argmax takes the first). Where the port compares two of its own
paths that sum in another order (the gather path against K3's plain version)
or a tree with near-ties between the packages (the swap's), a stream is held
up to its first step whose top-2 gap is at or below the 0.05 tie margin,
and the test asserts that it covered at least a token a stream."""

import asyncio
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.tpu.serving import GenerationServer as JaxGenerationServer
from arkflow_tpu_torch.components import ensure_plugins_loaded
from arkflow_tpu_torch.config import EngineConfig, StreamConfig
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.runtime import cli
from arkflow_tpu_torch.runtime.engine import Engine
from arkflow_tpu_torch.runtime.stream import build_stream
from arkflow_tpu_torch.tpu.batch_generate import BatchGenerator
from arkflow_tpu_torch.tpu.serving import TIE_MARGIN, GenerationServer
from tests.test_torch_moe import TINY_MOE

ensure_plugins_loaded()

PROMPTS = [[9], [55, 1, 2, 8, 13], [9, 4], [2, 77, 31, 5], [60, 61, 62]]
#: PROMPTS behind a shared 8-token (two-page) head: the second wave hits
#: the prefixes the first donated
SHARED = [[7, 3, 11, 5, 19, 23, 29, 31] + p for p in PROMPTS]
SERVER = dict(slots=2, page_size=4, max_seq=32)
EXAMPLE = (Path(__file__).resolve().parent.parent / "arkflow_tpu_torch" / "examples"
           / "llama_moe_stream.json")


def _trees(seed: int, **overrides):
    fam = jax_get_model("decoder_lm")
    jcfg = fam.make_config(**{**TINY_MOE, **overrides})
    jparams = fam.init(jax.random.PRNGKey(seed), jcfg)
    return (fam, jparams, jcfg, params_from_jax(jax.device_get(jparams)),
            get_model("decoder_lm").make_config(**{**TINY_MOE, **overrides}))


@pytest.fixture(scope="module")
def seed2():
    return _trees(2)


def _run(server, prompts, max_new, *, waves=1):
    """The streams of ``prompts`` (``waves`` times over, one wave after the
    other), then the server closed."""
    async def go():
        outs = []
        for _ in range(waves):
            outs += await asyncio.gather(*[server.generate(p, max_new_tokens=max_new)
                                           for p in prompts])
        await server.close()
        return outs

    return asyncio.run(go())


def _margined(server, prompts, max_new):
    """The server's streams with every step's top-2 gap (``record_margins``)."""
    server.record_margins = True

    async def go():
        outs = await asyncio.gather(*[server.generate(p, max_new_tokens=max_new,
                                                      with_margins=True) for p in prompts])
        await server.close()
        return outs

    return asyncio.run(go())


def _held_to_first_tie(got, want) -> int:
    """Each stream of ``got`` (tokens, gaps) equals ``want``'s up to its
    first step whose gap is at or below ``TIE_MARGIN``; returns the tokens
    compared."""
    compared = 0
    for (tokens, gaps), ref in zip(got, want):
        k = next((j for j, g in enumerate(gaps) if g <= TIE_MARGIN), len(tokens))
        assert tokens[:k] == ref[:k]
        compared += k
    return compared


def test_server_greedy_streams_match_jax(seed2):
    """Five prompts over two slots (admission, slot reuse, idle lanes):
    the port's streams are JAX's server's; the decode and prefill keys
    were each captured once."""
    _, jparams, jcfg, params, cfg = seed2
    want = _run(JaxGenerationServer(jparams, jcfg, **SERVER), PROMPTS, 6)
    server = GenerationServer(params, cfg, **SERVER)
    assert _run(server, PROMPTS, 6) == want
    assert server.decode_steps > 0 and server.prefill_steps > 0
    assert set(server.replay_counts()) == {("decode", "gather"), ("prefill", 32)}


@pytest.mark.parametrize("feature", ["speculative", "prefix_cache", "chunked"])
def test_server_features_compose_with_moe_as_in_jax(seed2, feature):
    """Speculative decoding (the verify key, ``slots x k`` tokens routed at
    once), the prefix cache (cached pages, the remainder through the chunk
    key) and chunked prefill: each stream equals JAX's server with the
    same feature, and the feature engaged."""
    _, jparams, jcfg, params, cfg = seed2
    kw, prompts, waves = {
        "speculative": (dict(speculative_tokens=3), [[5, 9] * 6, [3, 17, 42, 7, 91], [11]], 1),
        "prefix_cache": (dict(prefix_cache_pages=8), SHARED, 2),
        "chunked": (dict(prefill_chunk=4), [list(range(3, 19)), [9, 4], list(range(40, 50))],
                    1),
    }[feature]
    kw = {**SERVER, "max_seq": 40, **kw}
    want = _run(JaxGenerationServer(jparams, jcfg, **kw), prompts, 6, waves=waves)
    server = GenerationServer(params, cfg, **kw)
    assert _run(server, prompts, 6, waves=waves) == want
    if feature == "speculative":
        assert server.spec_accepted > 0 and server.verify_steps > 0
        assert ("verify", 4, "gather") in server.replay_counts()
    elif feature == "prefix_cache":
        assert server.prefix_hits > 0 and server.chunk_steps > 0
    else:
        assert server.chunk_steps > 0


def test_parity_gate_and_paged_path_carry_moe(seed2):
    """``decode_kernel: paged`` (K3's plain version on the CPU): the init
    parity gate runs through the MoE layers and passes, and the streams
    equal the gather path's up to the first near-tie."""
    _, jparams, jcfg, params, cfg = seed2
    want = _run(GenerationServer(params, cfg, **SERVER), PROMPTS, 6)
    server = GenerationServer(params, cfg, decode_kernel="paged", **SERVER)
    assert server.parity_report["mismatches"] == 0 and server.parity_report["rows_checked"] > 0
    assert _held_to_first_tie(_margined(server, PROMPTS, 6), want) >= len(PROMPTS)


def test_swap_to_another_moe_tree_serves_its_streams(seed2):
    """A hot swap copies the expert stacks and the router into the live
    tensors (the captured addresses kept): afterwards the streams are JAX's
    server's on the new tree, up to the first near-tie."""
    _, _, _, params, cfg = seed2
    _, jnew, jcfg, new, _ = _trees(5)
    want = _run(JaxGenerationServer(jnew, jcfg, **SERVER), PROMPTS, 6)

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}

    server = GenerationServer(clone(params), cfg, **SERVER)
    experts = server.params["layers"]["experts"]["w_up"]

    async def swap():
        await server.swap_params(new)

    asyncio.run(swap())
    assert server.params["layers"]["experts"]["w_up"] is experts
    assert torch.equal(experts, new["layers"]["experts"]["w_up"])
    assert _held_to_first_tie(_margined(server, PROMPTS, 6), want) >= len(PROMPTS)


def test_bitflip_picks_the_jax_leaf_of_the_moe_tree(seed2, caplog):
    """JAX's ``_bitflip_params`` garbles the first largest float leaf; in
    the MoE tree that is an expert stack, and the port names the same."""
    import logging

    _, jparams, jcfg, params, cfg = seed2
    jserver = JaxGenerationServer(jparams, jcfg, **SERVER)
    with caplog.at_level(logging.WARNING):
        jserver.inject_step_fault("bitflip")
    want = [r.getMessage().rsplit(" ", 1)[-1] for r in caplog.records if "bitflip" in r.message]
    server = GenerationServer(params, cfg, **SERVER)
    assert want == [server.bitflip_leaf()] and "experts" in want[0]


@pytest.mark.parametrize("n_real", [4, 3, 1])
def test_batch_generator_matches_jax_generate_on_a_padded_bucket(seed2, n_real):
    """Batch mode over the contiguous cache (the prefill and decode steps on
    their static buffers): a bucket of 4 rows, ``n_real`` of them real and
    the rest padding rows of length 1 that decode unmasked, as JAX's
    ``tpu_generate`` pads its bucket. Tokens and counts exact."""
    fam, jparams, jcfg, params, cfg = seed2
    ids = np.zeros((4, 8), np.int32)
    lens = np.ones(4, np.int32)
    for i, p in enumerate([[3, 17, 42, 7, 91], [9, 4], [55, 1, 2, 8, 13, 6, 6, 2],
                           [60, 61, 62]][:n_real]):
        ids[i, :len(p)], lens[i] = p, len(p)
    jout, jcounts = fam.extras["generate"](jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens),
                                           max_new_tokens=7, n_real=n_real)
    gen = BatchGenerator(params, cfg, max_new_tokens=7)
    tokens, counts, _ = gen.generate(ids, lens, n_real, key=0)
    assert counts.tolist() == np.asarray(jcounts)[:n_real].tolist()
    assert tokens.tolist() == np.asarray(jout)[:n_real].tolist()


@pytest.mark.parametrize("experts", [1, 4])
def test_depth2_refuses_moe_with_jax_message(experts):
    """Queue C 1: ``dispatch_depth: 2`` with ``num_experts > 0`` raises
    JAX's ``ConfigError`` in the server and at the ``gpu_generate`` build
    (``tests/test_paged_kernel.py:390-395`` pins JAX's at 4)."""
    _, jparams, jcfg, params, cfg = _trees(0, num_experts=experts)
    with pytest.raises(JaxConfigError, match="MoE") as want:
        JaxGenerationServer(jparams, jcfg, dispatch_depth=2)
    with pytest.raises(ConfigError, match="MoE") as got:
        GenerationServer(params, cfg, dispatch_depth=2)
    assert str(got.value) == str(want.value)
    proc = {"type": "gpu_generate", "model": "decoder_lm", "device": "cpu",
            "model_config": {**TINY_MOE, "num_experts": experts}, "serving": "continuous",
            "slots": 2, "page_size": 4, "max_input": 16, "max_new_tokens": 4,
            "dispatch_depth": 2}
    with pytest.raises(ConfigError) as built:
        build_stream(StreamConfig.from_mapping({
            "input": {"type": "generate", "payload": "x", "count": 1},
            "pipeline": {"processors": [proc]}, "output": {"type": "drop"}}))
    assert str(built.value) == str(want.value)


def test_moe_example_validates_as_shipped():
    """``llama_moe_stream.json``: Llama-3-8B widths, 8 experts, 16 layers,
    depth 1, and ``--validate`` passes."""
    cfg = json.loads(EXAMPLE.read_text())
    proc = cfg["streams"][0]["pipeline"]["processors"][0]
    model = proc["model_config"]
    assert (model["dim"], model["ffn"], model["heads"], model["kv_heads"]) == (4096, 14336, 32, 8)
    assert (model["num_experts"], model["layers"], proc["dispatch_depth"]) == (8, 16, 1)
    assert cli.main(["--config", str(EXAMPLE), "--validate"]) == 0


def test_moe_example_at_tiny_width():
    """The example with a tiny MoE decoder (8 experts) on the CPU: every
    row delivered in order with at most ``max_new_tokens`` each, chunked
    and one-shot prefills and decode steps run, no page leaked."""
    cfg = json.loads(EXAMPLE.read_text())
    proc = cfg["streams"][0]["pipeline"]["processors"][0]
    proc.update(device="cpu", max_new_tokens=8,
                model_config={**TINY_MOE, "num_experts": 8, "max_seq": 1024})
    engine = Engine(EngineConfig.from_mapping(cfg))
    stream = engine.build()[0]
    server = stream.pipeline.processors[0].server
    asyncio.run(asyncio.wait_for(engine.run(), 120))
    count = cfg["streams"][0]["input"]["count"]
    assert stream.rows_out == count and stream.output.dropped_rows == count
    assert stream.errors == 0 and server.tokens <= 8 * count
    assert server.chunk_steps > 0 and server.prefill_steps > 0 and server.decode_steps > 0
    assert len(server._free_pages) == server.num_pages - 1


@pytest.mark.parametrize("serving_dtype", ["bfloat16", "int8"])
def test_model_runner_serves_moe_like_jax(serving_dtype):
    """``gpu_inference``'s runner on the MoE decoder (the full forward,
    unmasked), at bf16 and at int8 (the router quantized, the expert
    stacks kept in bf16): logits against JAX's forward, run op by op on
    the tree JAX's runner would serve (``convert_for_serving``), within
    1/64 plus one bf16 step (XLA's fused rounding in a jitted JAX step
    flips near-tied router choices, so a jitted step is not the
    yardstick); int8 products counted for the dense layers and the router
    only."""
    from arkflow_tpu.tpu.runner import convert_for_serving
    from arkflow_tpu_torch.models import quantize as q8
    from arkflow_tpu_torch.tpu.bucketing import BucketPolicy
    from arkflow_tpu_torch.tpu.runner import ModelRunner

    fam = jax_get_model("decoder_lm")
    host = jax.device_get(fam.init(jax.random.PRNGKey(2), fam.make_config(**TINY_MOE)))
    ids = np.random.default_rng(2).integers(3, 128, (2, 16)).astype(np.int32)
    served = convert_for_serving(jax.tree_util.tree_map(jnp.asarray, host), serving_dtype)
    with jax.disable_jit():
        want = {"logits": np.asarray(fam.apply(served, fam.make_config(**TINY_MOE),
                                               input_ids=jnp.asarray(ids))["logits"])}
    runner = ModelRunner("decoder_lm", TINY_MOE, buckets=BucketPolicy((2,), (16,)),
                         device="cpu", host_params=params_from_jax(host),
                         serving_dtype=serving_dtype)
    before = q8.int8_products.value
    got = runner.infer_sync({"input_ids": ids})
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1.0 / 64, rtol=2.0 ** -7)
    int8 = serving_dtype == "int8"
    assert "w_q" in runner.params["layers"]["router"] if int8 else "w" in \
        runner.params["layers"]["router"]
    # per layer wq, wk, wv, wo and the router; then the LM head
    assert q8.int8_products.value - before == (5 * TINY_MOE["layers"] + 1 if int8 else 0)


def test_integrity_repairs_a_bitflip_in_the_expert_stacks():
    """The integrity monitor on an MoE server: the bitflip lands in an
    expert stack (JAX's pick), the digest pass names it, the server is
    quarantined and repaired from the host copy, and the texts come back
    bit for bit."""
    from arkflow_tpu_torch.batch import MessageBatch
    from arkflow_tpu_torch.components import Resource
    from arkflow_tpu_torch.components.registry import build_component

    proc = build_component("processor", {
        "type": "gpu_generate", "model": "decoder_lm", "model_config": TINY_MOE,
        "max_input": 16, "max_new_tokens": 4, "seq_buckets": [16], "serving": "continuous",
        "slots": 2, "page_size": 4, "device": "cpu",
        "integrity": {"probe_interval": "999s", "digest_every": 1}}, Resource())
    mon, srv = proc.integrity, proc.server
    batch = MessageBatch.new_binary([b"sensor alpha", b"pressure spike on line four"])

    async def go():
        await proc.connect()
        before = await proc.process(batch)
        assert (await mon.probe_now())["ok"] == 1
        proc.runner.inject_step_fault("bitflip")
        rep = await mon.probe_now()
        assert rep["mismatches"] == 1 and rep["repaired"] == 1, rep
        after = await proc.process(batch)
        await proc.close()
        return before, after, rep

    before, after, rep = asyncio.run(go())
    assert "experts" in srv.bitflip_leaf()
    assert mon.results["digest_mismatch"] == 1 and srv.health.state == "healthy"
    assert before[0].column("generated").to_pylist() == after[0].column("generated").to_pylist()
