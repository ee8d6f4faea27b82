"""The generation server's lifecycle in the port (``tpu/serving.py``,
``GenerationServerUnit`` and ``build_generate_swapper`` in ``tpu/swap.py``,
``ServerIntegrityMember`` and ``build_generate_integrity_monitor`` in
``tpu/integrity.py``, the ``gpu_generate`` keys) on the CPU, against the
JAX package's ``GenerationServer`` and ``tpu_generate`` on the same weights
(``params_from_jax``), as ``tests/test_paged_serving.py``,
``tests/test_hotswap.py`` and ``tests/test_integrity.py`` drive them:

- deadlines: a hung step fails its requests, marks the server UNHEALTHY and
  the probe recovers it, with the health trace of the JAX server on the
  same calls; in a stream the batch nacks and its redelivery heals;
- OOM: the requests fail, the pages return, the pools are zeroed, the next
  step probes;
- rebuild: after a miss the server serves from a new ``CompiledStep`` over
  new pools, a zombie that wakes late writes only the old pools, and the
  greedy streams equal JAX's;
- swap: the processor's alias stays in sync, the grid drains and the pools
  reset, in-flight requests are never dropped, a swap to JAX's seed-1 tree
  serves JAX's streams on it, and a corrupt checkpoint, a crash and a drain
  timeout leave the old weights serving;
- integrity: digests and the golden reference equal JAX's; a bitflip is
  quarantined and repaired; ``repair: false`` leaves it CORRUPT; a swap is
  never read as corruption;
- chaos, report, config and the lifecycle example at a tiny width.
"""

import asyncio
import json
import logging
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.errors import StepDeadlineExceeded as JaxStepDeadlineExceeded
from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.tpu import integrity as jax_integrity
from arkflow_tpu.tpu import swap as jax_swap
from arkflow_tpu.tpu.health import HealthConfig as JaxHealthConfig
from arkflow_tpu.tpu.serving import GenerationServer as JaxGenerationServer
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, ensure_plugins_loaded
from arkflow_tpu_torch.components.registry import build_component
from arkflow_tpu_torch.config import EngineConfig
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError, StepDeadlineExceeded, SwapError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.runtime import cli
from arkflow_tpu_torch.runtime.engine import Engine
from arkflow_tpu_torch.tpu import checkpoint
from arkflow_tpu_torch.tpu.health import HealthConfig
from arkflow_tpu_torch.tpu.integrity import find_golden_reference, flatten, tree_digests
from arkflow_tpu_torch.tpu.serving import GenerationServer
from arkflow_tpu_torch.tpu.serving_core import is_oom_error

ensure_plugins_loaded()

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "arkflow_tpu_torch" / "examples" / "llama_lifecycle_stream.json"
TINY = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, ffn=96, max_seq=64)
#: the JAX hot-swap suite's decoder
TINY_LM = dict(vocab_size=128, dim=16, layers=1, heads=2, kv_heads=2, ffn=32, max_seq=64)
TP_PROMPTS = [[9], [55, 1, 2, 8, 13], [9, 4], [2, 77, 31, 5], [60, 61, 62]]
SERVER = dict(slots=2, page_size=4, max_seq=40)
#: the warm step deadline of these tests: a TINY step takes milliseconds,
#: and a loaded CPU must not read one as hung
DEADLINE = 1.0
#: a top-2 logit gap at or below it lets two correct paths pick differently
TIE_MARGIN = 0.05


def _jax_tree(model_config: dict, seed: int):
    fam = jax_get_model("decoder_lm")
    cfg = fam.make_config(**model_config)
    return fam.init(jax.random.PRNGKey(seed), cfg), cfg


def _port(jparams) -> dict:
    return params_from_jax(jax.device_get(jparams))


@pytest.fixture(scope="module")
def weights():
    """JAX's TINY decoder under seed 3 (tie-free on ``TP_PROMPTS``), its
    port tree, both configs, and JAX's greedy streams on it."""
    jparams, jcfg = _jax_tree(TINY, 3)
    cfg = get_model("decoder_lm").make_config(**TINY)
    ref = asyncio.run(_serve(JaxGenerationServer(jparams, jcfg, **SERVER), TP_PROMPTS, 6))
    return jparams, jcfg, _port(jparams), cfg, ref


async def _serve(server, prompts, max_new, close=True):
    outs = await asyncio.gather(*[server.generate(p, max_new_tokens=max_new) for p in prompts])
    if close:
        await server.close()
    return outs


def _trace(server, jax_side: bool) -> tuple:
    """The health machine's state, consecutive failures, deadline misses
    and rebuilds (JAX: the core's counters)."""
    core = server.core
    rep = core.health.report()
    if jax_side:
        counts = (core.m_deadline_miss.value, core.m_rebuilds.value)
    else:
        counts = (core.deadline_misses, core.rebuilds)
    return rep["state"], rep["consecutive_failures"], *counts


def _wait_zombies(core, timeout_s: float = 10.0) -> None:
    end = time.monotonic() + timeout_s
    while core.zombies and time.monotonic() < end:
        time.sleep(0.02)
    assert core.zombies == 0


# -- deadlines, OOM, rebuild ---------------------------------------------------


async def _incident_script(server, kind: str, prompt, jax_side: bool) -> list:
    """Warm the shapes, arm ``kind`` on the next step, submit (it fails),
    then submit again (the probe): the trace after each call, the outputs."""
    trace, outs = [_trace(server, jax_side)], []
    outs.append(await server.generate(prompt, max_new_tokens=4))
    trace.append(_trace(server, jax_side))
    server.inject_step_fault(kind, 3.0)
    err = JaxStepDeadlineExceeded if jax_side and kind == "hang" else (
        StepDeadlineExceeded if kind == "hang" else Exception)
    with pytest.raises(err) as info:
        await server.generate(prompt, max_new_tokens=4)
    if kind == "oom":
        assert is_oom_error(info.value)
    trace.append(_trace(server, jax_side))
    outs.append(await server.generate(prompt, max_new_tokens=4))
    trace.append(_trace(server, jax_side))
    await server.close()
    return [(s, f, m - trace[0][2], r - trace[0][3]) for s, f, m, r in trace], outs


@pytest.mark.parametrize("kind", ["hang", "oom"])
def test_incident_health_trace_matches_jax(weights, kind):
    """``tests/test_paged_serving.py:764`` on both servers: the trace of the
    health machine and the counters are JAX's, and the probe serves JAX's
    tokens."""
    jparams, jcfg, params, cfg, _ = weights
    kw = dict(step_deadline_s=DEADLINE, step_deadline_first_s=60.0, **SERVER)
    want, jax_outs = asyncio.run(_incident_script(
        JaxGenerationServer(jparams, jcfg, health_config=JaxHealthConfig(probe_backoff_s=0.05),
                            **kw), kind, [9, 4], jax_side=True))
    server = GenerationServer(params, cfg, health_config=HealthConfig(probe_backoff_s=0.05),
                              **kw)
    got, outs = asyncio.run(_incident_script(server, kind, [9, 4], jax_side=False))
    assert got == want
    assert got[2][0] == "unhealthy" and got[3][0] == "healthy"
    assert outs == jax_outs and outs[0] == outs[1]
    assert len(server._free_pages) == server.num_pages - 1 and not server._page_refs
    _wait_zombies(server.core)


def test_oom_fails_requests_returns_pages_zeroes_pools_and_probes(weights):
    """Chaos ``oom`` on a generate step: every request in flight fails with
    the OOM, the pages return, the pools are zeroed in place (no step can
    still write them, and the graphs keep their addresses), and the next
    step is the probe that heals."""
    _, _, params, cfg, ref = weights

    async def go():
        server = GenerationServer(params, cfg, health_config=HealthConfig(probe_backoff_s=0.05),
                                  **SERVER)
        server.warmup()
        await _serve(server, TP_PROMPTS[:2], 6, close=False)
        pools, compiled = (server.k_pages, server.v_pages), server._compiled
        assert server.k_pages.abs().sum() > 0
        server.inject_step_fault("oom")
        results = await asyncio.gather(*[server.generate(p, max_new_tokens=6)
                                         for p in TP_PROMPTS], return_exceptions=True)
        failed = [r for r in results if isinstance(r, BaseException)]
        assert failed and all(is_oom_error(e) for e in failed)
        assert server.health.state == "unhealthy"
        assert len(server._free_pages) == server.num_pages - 1 and not server._page_refs
        assert (server.k_pages, server.v_pages) == pools and server._compiled is compiled
        assert not server.k_pages.any() and not server.v_pages.any()
        assert server.pool_renewals == 0 and server.core.rebuilds == 0 and server.ooms == 1
        outs = await _serve(server, TP_PROMPTS, 6)
        assert server.health.state == "healthy"
        return outs

    assert asyncio.run(go()) == ref


@pytest.mark.parametrize("kw", [{}, {"decode_kernel": "paged", "dispatch_depth": 2}],
                         ids=["gather", "paged-depth2"])
def test_rebuild_serves_from_a_new_compiled_step_over_new_pools(weights, kw):
    """After a miss: new pools at once (the zombie keeps the old ones, and
    writes only them when it wakes), a new ``CompiledStep`` and new host
    sets from the probe's rebuild, every warmed key captured again, and the
    greedy streams equal JAX's on ``TP_PROMPTS``."""
    _, _, params, cfg, ref = weights

    async def go():
        server = GenerationServer(params, cfg, step_deadline_s=DEADLINE, step_deadline_first_s=60.0,
                                  health_config=HealthConfig(probe_backoff_s=0.05), **SERVER,
                                  **kw)
        keys = server.warmup()
        old_compiled, old_host = server._compiled, server._host
        old_k, old_v = server.k_pages, server.v_pages
        server.inject_step_fault("hang", 1.5 * DEADLINE)
        results = await asyncio.gather(*[server.generate(p, max_new_tokens=6)
                                         for p in TP_PROMPTS], return_exceptions=True)
        assert any(isinstance(r, StepDeadlineExceeded) for r in results)
        assert server.k_pages is not old_k and server.v_pages is not old_v
        assert server.pool_renewals == 1 and server.health.state == "unhealthy"
        snapshot = old_k.clone()
        await asyncio.get_running_loop().run_in_executor(None, _wait_zombies, server.core)
        # the zombie ran its step after all, into the old pools only
        assert not torch.equal(old_k, snapshot)
        assert not server.k_pages.any() and not server.v_pages.any()
        outs = await _serve(server, TP_PROMPTS, 6)
        assert server._compiled is not old_compiled and server._host is not old_host
        assert set(server._compiled.keys()) == set(old_compiled.keys())
        assert server.captures == 2 * keys and server.last_rebuild_ms is not None
        assert (server.core.deadline_misses, server.core.rebuilds) == (1, 1)
        assert server.health.state == "healthy"
        return outs

    assert asyncio.run(go()) == ref


def _stream_cfg(**proc) -> dict:
    """``tests/test_paged_serving.py:803`` in the port: three rows, one a
    batch, through a redelivering fault input; the hang armed at call 2."""
    inner = {"type": "gpu_generate", "model": "decoder_lm", "model_config": TINY,
             "serving": "continuous", "slots": 2, "page_size": 4, "max_input": 16,
             "max_new_tokens": 4, "eos_id": -1, "seq_buckets": [16], "device": "cpu",
             "step_deadline": f"{DEADLINE}s", "step_deadline_first": "60s",
             "health": {"probe_backoff": "50ms"}, **proc}
    return {"streams": [{
        "name": "gen-deadline",
        "input": {"type": "fault", "redeliver_unacked": True,
                  "inner": {"type": "generate", "payloads": ["r0", "r1", "r2"],
                            "batch_size": 1, "count": 3}},
        "pipeline": {"thread_num": 1, "max_delivery_attempts": 5, "processors": [
            {"type": "fault", "faults": [{"kind": "hang", "at": 2, "duration": "3s"}],
             "inner": inner}]},
        "output": {"type": "drop"}}]}


def test_stream_deadline_miss_nacks_and_redelivery_heals():
    engine = Engine(EngineConfig.from_mapping(_stream_cfg()))
    stream = engine.build()[0]
    server = stream.pipeline.processors[0].runner  # through the fault wrapper
    asyncio.run(asyncio.wait_for(engine.run(), 120))
    assert stream.rows_out == 3 and stream.output.dropped_rows == 3
    assert stream.errors >= 1 and stream.input.redeliveries == stream.errors
    assert server.core.deadline_misses == 1 and server.core.rebuilds == 1
    assert server.health.state == "healthy"
    assert len(server._free_pages) == server.num_pages - 1
    _wait_zombies(server.core)


# -- hot swap -----------------------------------------------------------------


def _proc(model_config=TINY_LM, **extra):
    cfg = {"type": "gpu_generate", "model": "decoder_lm", "model_config": model_config,
           "max_input": 16, "max_new_tokens": 4, "seq_buckets": [16], "serving": "continuous",
           "slots": 2, "page_size": 4, "device": "cpu", **extra}
    return build_component("processor", cfg, Resource())


async def _admitted(server) -> None:
    while all(r is None for r in server._slot_req):
        await asyncio.sleep(0.001)


def _texts(batch) -> list:
    return batch[0].column("generated").to_pylist()


def _ptrs(params) -> list[int]:
    return [t.data_ptr() for t in flatten(params).values()]


def _holds(live: dict, host: dict) -> bool:
    """Does the live tree hold the host tree's values (cast to its dtypes)?"""
    want = flatten(host)
    return all(torch.equal(t, want[p].to(t.dtype)) for p, t in flatten(live).items())


def test_continuous_swap_keeps_the_processor_alias_in_sync(tmp_path):
    """``tests/test_hotswap.py:416``: the processor's ``params`` is the
    server's live tree after a swap, by data and by address."""
    proc = _proc(swap={"canary": {"min_agreement": 0.0}})
    new = _port(_jax_tree(TINY_LM, 1)[0])
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, new)
    ptrs = _ptrs(proc.params)

    async def go():
        await proc.connect()
        rep = await proc.swapper.swap(ck)
        await proc.close()
        return rep

    assert asyncio.run(go())["version"] == 1
    assert proc.params is proc.server.params and _ptrs(proc.params) == ptrs
    assert _holds(proc.params, new)
    assert proc.host_params is not None  # the committed host tree: the repair source


def test_continuous_swap_drains_and_resets_the_pools(tmp_path):
    """``tests/test_hotswap.py:510`` without the prefix cache: the swap
    leaves a clean ledger, zeroed pools, no draining flag, unchanged
    captures and the same texts for the same weights."""
    proc = _proc()
    srv = proc.server
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, proc.params)
    batch = MessageBatch.new_binary([b"repeated prompt text goes here"])

    async def go():
        await proc.connect()
        before = await proc.process(batch)
        captures = srv.captures
        assert srv.k_pages.any()
        rep = await proc.swapper.swap(ck)
        assert rep["version"] == 1 and srv.captures == captures
        assert len(srv._free_pages) == srv.num_pages - 1 and not srv._page_refs
        assert not srv._draining and srv._pipeline is None
        assert srv.health_report()["draining"] is False
        after = await proc.process(batch)
        await proc.close()
        return before, after

    before, after = asyncio.run(go())
    assert _texts(before) == _texts(after)


def test_continuous_swap_under_inflight_load(tmp_path):
    """``tests/test_hotswap.py:541``: requests racing a swap are never
    dropped; identical weights give every output of the run without one."""
    proc = _proc(max_new_tokens=6, dispatch_depth=2)
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, proc.params)
    prompts = [f"prompt number {i} padding words".encode() for i in range(6)]

    async def go():
        await proc.connect()
        baseline = await proc.process(MessageBatch.new_binary(prompts))
        tasks = [asyncio.create_task(proc.process(MessageBatch.new_binary([p])))
                 for p in prompts]
        await asyncio.sleep(0.01)
        assert (await proc.swapper.swap(ck))["version"] == 1
        outs = await asyncio.gather(*tasks)
        await proc.close()
        return baseline, outs

    baseline, outs = asyncio.run(go())
    assert [_texts(o)[0] for o in outs] == _texts(baseline)


def _as_served(jparams, like: dict):
    """A JAX tree cast leaf by leaf to the dtypes of a served port tree
    (bf16 dense and embedding weights, f32 norm scales), as a restore into
    that tree casts it."""
    dtypes = {p: str(t.dtype).removeprefix("torch.") for p, t in flatten(like).items()}
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x.astype(dtypes[jax.tree_util.keystr(path)]), jparams)


def test_swap_to_jax_seed1_tree_serves_jax_streams(tmp_path):
    """Swaps to checkpoints of JAX's seed-3 and seed-1 trees: after each the
    server's greedy streams equal JAX's server on that tree as served (cast
    to the live dtypes), with the live addresses and the captures kept.
    Seed 3 is tie-free on ``TP_PROMPTS``; under seed 1 some steps' top two
    logits tie to the last bit, and two correct summation orders may break
    such a tie either way, so each stream is held up to its first step
    whose top-2 gap is at or below ``TIE_MARGIN``."""
    proc = _proc(TINY, max_input=24, seq_buckets=[8, 24], max_new_tokens=6,
                 dispatch_depth=2, swap={"canary": {"min_agreement": 0.0}})
    srv = proc.server
    srv.record_margins = True
    refs, cks = [], []
    for seed in (3, 1):
        jparams, jcfg = _jax_tree(TINY, seed)
        cks.append(str(tmp_path / f"seed{seed}"))
        checkpoint.save(cks[-1], _port(jparams))
        refs.append(asyncio.run(_serve(JaxGenerationServer(_as_served(jparams, srv.params), jcfg,
                                                           **SERVER), TP_PROMPTS, 6)))

    async def serve():
        return await asyncio.gather(*[srv.generate(p, max_new_tokens=6, with_margins=True)
                                      for p in TP_PROMPTS])

    async def go():
        await proc.connect()
        runs = []
        for ck in cks:
            await proc.swapper.swap(ck)
            if not runs:
                ptrs, captures = _ptrs(srv.params), srv.captures
            runs.append(await serve())
        assert _ptrs(srv.params) == ptrs and srv.captures == captures
        assert proc.swapper.version == 2
        await proc.close()
        return runs

    (seed3, seed1) = asyncio.run(go())
    assert [t for t, _ in seed3] == refs[0]
    compared = 0
    for (got, gaps), want in zip(seed1, refs[1]):
        k = next((j for j, g in enumerate(gaps) if g <= TIE_MARGIN), len(got))
        assert got[:k] == want[:k]
        compared += k
    assert compared >= len(TP_PROMPTS) and refs[0] != refs[1]


@pytest.mark.parametrize("fault", ["swap_corrupt", "swap_crash", "drain_timeout"])
def test_failed_swap_leaves_the_old_weights_serving(tmp_path, fault):
    """A corrupt checkpoint (the canary rejects it), a crash after the flip
    (rolled back through ``swap_params``) and a grid that does not drain in
    time: ``SwapError``, the old weights and texts, no version change."""
    proc = _proc(swap={"canary": {"rows": 16}, "drain_timeout": "50ms"}, max_new_tokens=12,
                 eos_id=-1)
    srv = proc.server
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, _port(_jax_tree(TINY_LM, 0)[0]) if fault != "swap_corrupt"
                    else proc.params)
    old = {k: v.clone() for k, v in flatten(proc.params).items()}
    batch = MessageBatch.new_binary([b"one small step", b"for a model"])

    async def go():
        await proc.connect()
        before = await proc.process(batch)
        if fault == "drain_timeout":
            # a request whose next step stalls 0.5 s holds its slot past the
            # 50 ms drain budget
            busy = asyncio.create_task(srv.generate([3] * 8, max_new_tokens=12))
            await asyncio.wait_for(_admitted(srv), 10)
            srv.inject_step_fault("hang", 0.5)
            proc.swapper.cfg = type(proc.swapper.cfg)(canary_rows=0)
        else:
            if fault == "swap_crash":
                proc.swapper.cfg = type(proc.swapper.cfg)(canary_rows=0)
            proc.swapper.inject_swap_fault(fault)
        with pytest.raises(SwapError):
            await proc.swapper.swap(ck)
        if fault == "drain_timeout":
            await busy
        after = await proc.process(batch)
        await proc.close()
        return before, after

    before, after = asyncio.run(go())
    assert _texts(before) == _texts(after)
    assert all(torch.equal(old[k], v) for k, v in flatten(proc.params).items())
    assert proc.swapper.version == 0 and proc.swapper.rolled_back == 1
    assert not srv._draining and srv.health.state == "healthy"


# -- integrity ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_digests_equal_jax_for_the_decoder_tree(dtype):
    jparams, _ = _jax_tree(TINY, 3)
    if dtype == "bfloat16":
        jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jparams)
    assert tree_digests(_port(jparams)) == jax_integrity.tree_digests(jparams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_golden_reference_for_decoder_lm_matches_jax(dtype):
    """``find_golden_reference`` on the decoder tree picks JAX's seed and
    signature; at bf16 the 1/64 floor makes the search step past seeds."""
    jparams, jcfg = _jax_tree(TINY, 3)
    if dtype == "bfloat16":
        jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jparams)
    want = jax_integrity.find_golden_reference(
        jax_get_model("decoder_lm"), jcfg, jparams, rows=2, seq=16, seed=2317,
        serving_dtype=dtype)
    got = find_golden_reference(
        get_model("decoder_lm"), get_model("decoder_lm").make_config(**TINY), _port(jparams),
        rows=2, seq=16, seed=2317, serving_dtype=dtype)
    assert got.seed == want.seed
    np.testing.assert_array_equal(got.signature, want.signature)
    for k in want.inputs:
        np.testing.assert_array_equal(got.inputs[k], want.inputs[k])


def _integrity_proc(**integrity):
    return _proc(TINY, max_new_tokens=6,
                 integrity={"probe_interval": "999s", "digest_every": 1, **integrity})


def test_monitor_catches_a_bitflip_quarantines_and_repairs():
    """``tests/test_integrity.py:232`` on the server member: the digest pass
    names the flipped leaf, the golden forward proves it, the server goes
    CORRUPT (readiness would answer 503), the repair copies the retained
    host tree back through ``swap_params``, and the texts come back bit for
    bit on the same digest epoch."""
    proc = _integrity_proc()
    mon, srv = proc.integrity, proc.server
    batch = MessageBatch.new_binary([b"sensor alpha", b"pressure spike on line four"])
    states = []

    async def go():
        await proc.connect()
        before = await proc.process(batch)
        rep = await mon.probe_now()
        assert rep["checked"] == 1 and rep["ok"] == 1, rep
        epoch0 = mon.digest_epoch()
        assert epoch0 is not None
        mon.add_quarantine_hook(lambda: states.append(srv.health_report()["state"]))
        ptrs = _ptrs(srv.params)
        proc.runner.inject_step_fault("bitflip")
        rep = await mon.probe_now()
        assert rep["mismatches"] == 1 and rep["repaired"] == 1, rep
        assert mon.results["digest_mismatch"] == 1
        assert mon.digest_epoch() == epoch0 and _ptrs(srv.params) == ptrs
        assert srv.health.state == "healthy"
        after = await proc.process(batch)
        rep = await mon.probe_now()
        assert rep["ok"] == 1 and rep["mismatches"] == 0
        await proc.close()
        return before, after

    before, after = asyncio.run(go())
    assert states == ["corrupt"]
    assert _texts(before) == _texts(after)


def test_monitor_repair_false_leaves_the_server_quarantined():
    proc = _integrity_proc(repair=False)
    mon = proc.integrity

    async def go():
        await mon.probe_now()
        proc.runner.inject_step_fault("bitflip")
        rep = await mon.probe_now()
        assert rep["mismatches"] == 1 and rep["repaired"] == 0, rep
        assert mon.members[0].state() == "corrupt"
        rep = await mon.probe_now()
        assert rep["repaired"] == 0 and mon.report()["members"][0]["state"] == "corrupt"

    asyncio.run(go())


def test_swap_to_new_weights_never_false_quarantines_and_repair_keeps_them(tmp_path):
    """``tests/test_integrity.py:306`` on the server member: a committed
    swap rebuilds the golden reference and the baseline, and a repair after
    it converges to the new weights, never back to the old."""
    proc = _integrity_proc()
    proc.swapper.cfg = type(proc.swapper.cfg)(min_agreement=0.0)
    mon = proc.integrity
    assert proc.swapper.integrity is mon
    new = _port(_jax_tree(TINY, 42)[0])
    ck = str(tmp_path / "ck42")
    checkpoint.save(ck, new)

    async def go():
        assert (await mon.probe_now())["ok"] == 1
        old_golden, old_epoch = mon.members[0].golden, mon.digest_epoch()
        assert (await proc.swapper.swap(ck))["version"] == 1
        assert not mon._suspended and mon.members[0].golden is not old_golden
        rep = await mon.probe_now()
        assert rep["mismatches"] == 0 and rep["ok"] == 1, rep
        assert mon.digest_epoch() not in (None, old_epoch)
        proc.runner.inject_step_fault("bitflip")
        rep = await mon.probe_now()
        assert rep["repaired"] == 1, rep

    asyncio.run(go())
    assert _holds(proc.params, new)


def test_monitor_serving_dtype_is_jax_pick():
    """The margin floor is that of the first float leaf in JAX's flatten
    order, on the port's bf16 tree as on JAX's f32 one."""
    from arkflow_tpu_torch.tpu.integrity import serving_dtype_of

    jparams, _ = _jax_tree(TINY, 3)
    assert serving_dtype_of(_port(jparams)) == "float32"
    assert serving_dtype_of(_proc(TINY).params) == "bfloat16"


# -- chaos and report -----------------------------------------------------------


def test_sdc_raises_with_jax_reason(weights):
    jparams, jcfg, params, cfg, _ = weights
    with pytest.raises(JaxConfigError) as want:
        JaxGenerationServer(jparams, jcfg, **SERVER).inject_step_fault("sdc")
    with pytest.raises(ConfigError) as got:
        GenerationServer(params, cfg, **SERVER).inject_step_fault("sdc")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("model_config", [TINY, TINY_LM], ids=["tiny", "tiny_lm"])
def test_bitflip_garbles_jax_leaf_in_place(model_config, caplog):
    """The leaf JAX's ``_bitflip_params`` picks (``['layers']['w_down']['w']``
    at TINY, ``['embed']['table']`` at TINY_LM), garbled to JAX's values,
    in place; nothing else changes."""
    jparams, jcfg = _jax_tree(model_config, 3)
    jserver = JaxGenerationServer(jparams, jcfg, **SERVER)
    with caplog.at_level(logging.WARNING):
        jserver.inject_step_fault("bitflip")
    want = [r.getMessage().rsplit(" ", 1)[-1] for r in caplog.records if "bitflip" in r.message]
    server = GenerationServer(_port(jparams), get_model("decoder_lm").make_config(**model_config),
                              **SERVER)
    ptrs = _ptrs(server.params)
    assert want == [server.bitflip_leaf()]
    server.inject_step_fault("bitflip")
    assert _ptrs(server.params) == ptrs
    flipped = _port(jserver.params)
    for path, leaf in flatten(server.params).items():
        assert torch.equal(leaf, flatten(flipped)[path]), path


def test_health_report_has_jax_keys(weights):
    """``tests/test_paged_serving.py:847`` without the prefix cache: JAX's
    keys (``mesh`` only under a mesh), the serving detail after traffic."""
    jparams, jcfg, params, cfg, _ = weights

    async def go(server):
        await _serve(server, TP_PROMPTS, 6, close=False)
        await asyncio.sleep(0.3)
        await _serve(server, TP_PROMPTS, 6)
        return server.health_report()

    want = asyncio.run(go(JaxGenerationServer(jparams, jcfg, **SERVER)))
    got = asyncio.run(go(GenerationServer(params, cfg, **SERVER)))
    assert set(want) <= set(got)
    for key in ("serving", "decode_kernel", "dispatch_depth", "draining", "slots",
                "slots_busy", "page_pool_occupancy", "state"):
        assert got[key] == want[key], key
    assert got["prefix_cache"] == {"entries": 0, "pages": 0, "capacity_pages": 0}
    assert got["tokens_per_sec"] > 0 and got["ttft"]["count"] == 2 * len(TP_PROMPTS)
    assert set(got["ttft"]) == set(want["ttft"])


# -- config, checkpoint and the example ------------------------------------------


@pytest.mark.parametrize("wrapped", [False, True], ids=["plain", "fault-inner"])
@pytest.mark.parametrize("patch", [
    {"step_deadline": "1s", "step_deadline_first": "60s"},
    {"health": {"probe_backoff": "100ms", "dead_after": 3}},
    {"checkpoint": "/ckpt"},
    {"swap": {"canary": {"rows": 4}, "drain_timeout": "30s"}},
    {"integrity": {"probe_interval": "5s", "digest_every": 4, "golden": {"rows": 1, "seq": 8}}},
])
def test_lifecycle_keys_validate(tmp_path, patch, wrapped):
    proc = {"type": "gpu_generate", "model_config": TINY, "serving": "continuous",
            "device": "cpu", **patch}
    if wrapped:
        proc = {"type": "fault", "faults": [], "inner": proc}
    cfg = {"streams": [{"input": {"type": "generate", "payload": "x", "count": 1},
                        "pipeline": {"processors": [proc]}, "output": {"type": "drop"}}]}
    assert not EngineConfig.from_mapping(cfg).validate_components()
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    assert cli.main(["--config", str(path), "--validate"]) == 0


@pytest.mark.parametrize("wrapped", [False, True], ids=["plain", "fault-inner"])
@pytest.mark.parametrize("key,block", [
    ("swap", {"canary": {"rows": -1}}), ("swap", {"bogus": 1}),
    ("swap", {"drain_timeout": "0s"}), ("integrity", {"digest_every": -1}),
    ("integrity", {"golden": {"rows": 0}}), ("integrity", [1]),
])
def test_bad_lifecycle_blocks_raise_jax_messages(key, block, wrapped):
    parse = {"swap": jax_swap.parse_swap_config,
             "integrity": jax_integrity.parse_integrity_config}[key]
    with pytest.raises(JaxConfigError) as want:
        parse(block, who="tpu_generate")
    proc = {"type": "gpu_generate", "model_config": TINY, "serving": "continuous", key: block}
    if wrapped:
        proc = {"type": "fault", "faults": [], "inner": proc}
    cfg = {"streams": [{"input": {"type": "generate", "payload": "x", "count": 1},
                        "pipeline": {"processors": [proc]}, "output": {"type": "drop"}}]}
    problems = EngineConfig.from_mapping(cfg).validate_components()
    assert len(problems) == 1
    assert problems[0].endswith(str(want.value).replace("tpu_generate", "gpu_generate"))


@pytest.mark.parametrize("deadline,match", [("0s", "step_deadline must be positive"),
                                            ("-1s", "invalid duration")])
def test_nonpositive_step_deadline_raises(deadline, match):
    proc = {"type": "gpu_generate", "model_config": TINY, "serving": "continuous",
            "step_deadline": deadline}
    with pytest.raises(ConfigError, match=match):
        build_component("processor", proc, Resource())


@pytest.mark.parametrize("keep", [{}, {"swap": {}}, {"integrity": {"probe_interval": "999s"}}],
                         ids=["none", "swap", "integrity"])
def test_checkpoint_restores_into_the_decoder_tree(tmp_path, keep):
    """``checkpoint`` restores a port checkpoint of the stacked decoder tree
    at build; the host copy is kept only when ``swap`` or ``integrity``
    needs a repair source."""
    host = _port(_jax_tree(TINY, 5)[0])
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, host)
    proc = _proc(TINY, checkpoint=ck, **keep)
    assert _holds(proc.params, host)
    assert (proc.host_params is not None) == bool(keep)
    if keep:
        assert tree_digests(proc.host_params) == tree_digests(proc.params)


def test_lifecycle_example_validates_as_shipped():
    assert cli.main(["--config", str(EXAMPLE), "--validate"]) == 0


def test_lifecycle_example_at_tiny_width():
    """``llama_lifecycle_stream.json`` with a tiny decoder on the CPU: every
    row delivered though a step hangs past its deadline and one runs out of
    memory; one miss, one rebuild over new pools, the nacked batches
    redelivered, HEALTHY at the end, no page leaked, the integrity probe
    passing."""
    cfg = json.loads(EXAMPLE.read_text())
    cfg["health_check"]["port"] = 0
    inner = cfg["streams"][0]["pipeline"]["processors"][0]["inner"]
    inner.update(model_config={"vocab_size": 128, "dim": 64, "layers": 2, "heads": 4,
                               "kv_heads": 2, "ffn": 96}, device="cpu")
    # the tiny model serves its rows in seconds: probe within that window
    inner["integrity"]["probe_interval"] = "500ms"
    engine = Engine(EngineConfig.from_mapping(cfg))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]
    server, mon = proc.runner, proc.integrity
    count = cfg["streams"][0]["input"]["inner"]["count"]
    asyncio.run(asyncio.wait_for(engine.run(), 120))
    _wait_zombies(server.core)
    assert stream.rows_out == count and stream.output.dropped_rows == count
    assert stream.errors >= 2 and stream.input.redeliveries == stream.errors
    rep = server.health_report()
    assert (rep["deadline_misses"], rep["rebuilds"], rep["pool_renewals"]) == (1, 1, 1)
    assert rep["state"] == "healthy" and rep["slots_busy"] == 0
    assert len(server._free_pages) == server.num_pages - 1
    assert mon.results["ok"] >= 1 and mon.results["mismatch"] == mon.results["error"] == 0
