"""The compiled step (``arkflow_tpu_torch.tpu.compiled_step``) and the
runner's dispatch plane around it, on the CPU: the runner and the
generation server on their static buffers and staging sets against
``eager=True`` and against the JAX package (JAX-initialised weights,
``params_from_jax``); the JAX tests that pin the dispatch plane, as
scenarios (``tests/test_paged_kernel.py`` depth 2 and staging sizing,
``tests/test_multichip.py`` compile count under threads,
``tests/test_tpu_layer.py`` pipelined infer and duty cycle); static
buffers under two threads; ``_disable_flash`` dropping the graphs; the
launch counters' capture arithmetic; and the host-sync scan of the code a
capture runs. CUDA graphs themselves are captured only on the card
(``chip_smoke.py``)."""

import ast
import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.tpu.bucketing import BucketPolicy as JaxBucketPolicy
from arkflow_tpu.tpu.runner import ModelRunner as JaxModelRunner
from arkflow_tpu.tpu.serving import GenerationServer as JaxGenerationServer
from arkflow_tpu_torch.components import Resource, ensure_plugins_loaded
from arkflow_tpu_torch.components.registry import build_component
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.ops import ragged_attention as ra
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy
from arkflow_tpu_torch.tpu.compiled_step import CompiledStep, DutyCycle
from arkflow_tpu_torch.tpu.runner import ModelRunner, StagingPool
from arkflow_tpu_torch.tpu.serving import GenerationServer
from tests.test_torch_generation_server import TINY, TP_PROMPTS
from tests.test_torch_runner import _inputs, _packed_layout
from tests.test_tpu_layer import TINY_BERT

ensure_plugins_loaded()

ROOT = Path(__file__).resolve().parent.parent
BATCH, SEQ = (4, 8), (16, 32)
LOGIT_ATOL = {"bfloat16": 1.0 / 64, "int8": 1e-2}  # the parity rules' floors
TIE_MARGIN = 0.05


@pytest.fixture(scope="module")
def bert_host():
    fam = jax_get_model("bert_classifier")
    return jax.device_get(fam.init(jax.random.PRNGKey(5), fam.make_config(**TINY_BERT)))


def _runner(host, **kw):
    kw.setdefault("buckets", BucketPolicy(BATCH, SEQ, example_scale=4))
    return ModelRunner("bert_classifier", TINY_BERT, device="cpu",
                       host_params=params_from_jax(host), **kw)


def _assert_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("mode", ["padded", "packed", "int8"])
def test_runner_compiled_path_equals_eager_and_jax(bert_host, mode):
    """The runner's step on its static buffers and staging sets: outputs
    bit-equal to ``eager=True`` on the same inputs at every step (a shape's
    first step and its later ones), and to the JAX runner on the same
    weights within the parity rules."""
    packed = mode == "packed"
    dtype = "int8" if mode == "int8" else None
    if packed:
        _, inputs = _packed_layout(8, 24, 24, 32)
        jbuckets = JaxBucketPolicy(BATCH, SEQ, example_scale=4)
    else:
        inputs = _inputs(11, 7, 24, 24)
        jbuckets = JaxBucketPolicy(BATCH, SEQ)
    compiled = _runner(bert_host, packed=packed, serving_dtype=dtype)
    eager = _runner(bert_host, packed=packed, serving_dtype=dtype, eager=True)
    first = compiled.infer_sync(inputs)
    again = compiled.infer_sync(inputs)
    _assert_equal(first, eager.infer_sync(inputs))
    _assert_equal(again, first)
    assert compiled.captures == 1 and compiled._compiled.replays == {
        k: 1 for k in compiled._compiled.keys()}
    assert compiled.device_steps == 2 and compiled.rows == 2 * len(first["label"])
    want = JaxModelRunner("bert_classifier", TINY_BERT, buckets=jbuckets,
                          host_params=bert_host, serving_dtype=dtype,
                          packed=packed).infer_sync(inputs)
    np.testing.assert_allclose(first["logits"], want["logits"],
                               atol=LOGIT_ATOL[dtype or "bfloat16"], rtol=0)
    top2 = np.sort(want["logits"], axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > TIE_MARGIN
    np.testing.assert_array_equal(first["label"][tie_free], want["label"][tie_free])


def test_warmup_captures_every_grid_shape_and_traffic_counts_apart(bert_host):
    runner = _runner(bert_host, packed=True)
    shapes = runner.grid_shapes(runner.buckets)
    pairs = sum(1 for eb in runner.buckets.example_buckets() for pb in BATCH if pb <= eb)
    assert len(shapes) == pairs * len(SEQ)
    assert runner.warmup() == len(shapes) == runner.captures
    assert runner.dispatch_counts() == {}
    _, inputs = _packed_layout(8, 24, 24, 32)
    runner.infer_sync(inputs)
    runner.infer_sync(inputs)
    (key, n), = runner.dispatch_counts().items()
    assert n == 2 and runner.captures == len(shapes)  # traffic replays, no capture
    assert runner._compiled.replays[key] == 2


def test_staging_sets_are_recycled_per_shape(bert_host):
    runner = _runner(bert_host)
    inputs = _inputs(3, 3, 10, 10)
    runner.infer_sync(inputs)
    (key, (bufs,)), = runner._staging._free.items()
    assert key == (("attention_mask", (4, 16)), ("input_ids", (4, 16)))
    runner.infer_sync(_inputs(4, 2, 12, 12))  # the same (4, 16) bucket
    (again,) = runner._staging._free[key]
    assert again is bufs and again.out is not None


def test_runner_dispatch_depth2_outputs_identical(bert_host):
    """``tests/test_paged_kernel.py:538``: depth 2 (the permit released at
    dispatch, the fetch outside it) gives depth 1's outputs, async twice
    (the shape's capture, then a replay) and sync."""
    r1, r2 = _runner(bert_host), _runner(bert_host, dispatch_depth=2)
    inp = _inputs(0, 6, 16, 16)

    async def go(r):
        return await r.infer(dict(inp)), await r.infer(dict(inp))

    (a1, b1), (a2, b2) = asyncio.run(go(r1)), asyncio.run(go(r2))
    _assert_equal(a2, a1)
    _assert_equal(b2, b1)
    _assert_equal(r2.infer_sync(dict(inp)), a1)


def test_runner_staging_pool_sizing_invariant(bert_host):
    """``tests/test_paged_kernel.py:563``: the staging cap covers every set
    held at once on a key -- dispatch_depth past the permit plus
    max_in_flight inside it -- sized at construction."""
    r = _runner(bert_host, dispatch_depth=2, max_in_flight=2)
    assert r._staging._max == r.max_in_flight + r.dispatch_depth
    assert r._staging._max >= r.dispatch_depth + 1
    with pytest.raises(ConfigError, match="dispatch_depth"):
        _runner(bert_host, dispatch_depth=0)
    with pytest.raises(AssertionError):
        StagingPool(max_per_key=0)


def test_seen_shapes_capture_count_thread_safe(bert_host):
    """``tests/test_multichip.py:320``: 16 concurrent first sightings of one
    padded shape capture it exactly once."""
    r = _runner(bert_host, buckets=BucketPolicy((8,), (16,)))
    inputs = _inputs(1, 5, 12, 12)
    with ThreadPoolExecutor(8) as ex:
        outs = list(ex.map(lambda _: r.infer_sync(inputs), range(16)))
    assert r.captures == 1
    for out in outs[1:]:
        _assert_equal(out, outs[0])


def test_async_infer_pipelines_and_tracks_duty_cycle(bert_host):
    """``tests/test_tpu_layer.py:406``: concurrent ``infer`` calls keep up
    to max_in_flight steps queued; the duty cycle lies in (0, 1] and every
    step drained."""
    runner = _runner(bert_host, buckets=BucketPolicy((4,), (16,)))
    runner.warmup()

    async def go():
        ids = np.ones((4, 16), np.int32)
        outs = await asyncio.gather(*[
            runner.infer({"input_ids": ids, "attention_mask": np.ones((4, 16), np.int32)})
            for _ in range(6)])
        assert all(o["label"].shape == (4,) for o in outs)

    asyncio.run(go())
    assert runner._duty.busy_s > 0
    assert 0.0 < runner.duty_cycle() <= 1.0
    assert runner._duty.inflight == 0


def test_duty_cycle_counts_overlap_once():
    d = DutyCycle()
    d.dispatch(0.0)
    d.dispatch(0.5)  # overlaps the first: one busy span
    d.complete(1.0)
    d.complete(2.0)
    d.dispatch(3.0)  # 1 s idle
    d.complete(4.0)
    assert d.busy_s == 3.0 and d.stall_s == 1.0 and d.share() == 0.75


@pytest.mark.parametrize("value,ok", [(None, True), (1, True), (2, True), ("2", True),
                                      (0, False), (-1, False), ("two", False)])
def test_gpu_inference_dispatch_depth(value, ok):
    """``gpu_inference`` reads ``dispatch_depth`` as the JAX processor does
    (an int, default 1, below 1 raises) and passes it to the runner."""
    cfg = {"type": "gpu_inference", "model": "bert_classifier", "device": "cpu",
           "model_config": TINY_BERT, "max_seq": 16, "batch_buckets": [4], "seq_buckets": [16]}
    if value is not None:
        cfg["dispatch_depth"] = value
    if not ok:
        with pytest.raises(ConfigError, match="dispatch_depth"):
            build_component("processor", cfg, Resource())
        return
    proc = build_component("processor", cfg, Resource())
    assert proc.runner.dispatch_depth == int(value or 1)


def test_two_threads_never_cross_static_buffers(bert_host):
    """Two executor threads infer different inputs of one shape through one
    runner many times: each result equals its own eager result."""
    runner = _runner(bert_host)
    eager = _runner(bert_host, eager=True)
    inputs = [_inputs(21, 4, 16, 16), _inputs(22, 4, 16, 16)]
    want = [eager.infer_sync(x) for x in inputs]
    assert not np.array_equal(want[0]["logits"], want[1]["logits"])
    errors = []

    def worker(i):
        for _ in range(12):
            got = runner.infer_sync(inputs[i])
            if not all(np.array_equal(got[k], want[i][k]) for k in want[i]):
                errors.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and runner.captures == 1


def test_disable_flash_drops_every_graph(bert_host):
    """The fallback to the plain attention changes ``cfg``: every captured
    graph is dropped, and the next step captures again from the new cfg."""
    runner = _runner(bert_host, buckets=BucketPolicy(BATCH, SEQ))
    runner.cfg = runner.cfg.__class__(**{**runner.cfg.__dict__, "use_flash_attention": True})
    runner.warmup()
    assert runner.captures == len(runner._compiled) == len(BATCH) * len(SEQ)
    left = {"input_ids": np.ones((2, 16), np.int32),
            "attention_mask": np.concatenate([np.zeros((2, 1), np.int32),
                                              np.ones((2, 15), np.int32)], axis=1)}
    got = runner.infer_sync(left)
    assert runner.flash_fallbacks == 1 and runner.cfg.use_flash_attention is False
    assert len(runner._compiled) == 1  # only the step after the fallback
    plain = _runner(bert_host, buckets=BucketPolicy(BATCH, SEQ), eager=True)
    _assert_equal(got, plain.infer_sync(left))


def test_launch_counts_under_capture_and_replay():
    """A launch counted while a graph is captured on this thread goes to the
    capture's tally, per counter and per variant; each replay adds it back;
    another thread counts as usual meanwhile."""
    a, b = ra.LaunchCounter(ra.VARIANTS), ra.LaunchCounter()
    a.add("mma")
    with ra.capturing() as tally:
        a.add("mma")
        a.add("mma")
        a.add("fma")
        b.add()
        other = threading.Thread(target=lambda: a.add("fma"))
        other.start()
        other.join()
    assert a.value == 2 and a.variants == {"mma": 1, "fma": 1}
    assert b.value == 0
    assert tally.counts == {a: (3, {"mma": 2, "fma": 1}), b: (1, {})}
    tally.replay()
    tally.replay()
    assert a.value == 8 and a.variants == {"mma": 5, "fma": 3} and b.value == 2
    a.add("mma")  # outside the capture: counted again
    assert a.value == 9


def test_compiled_step_keys_replays_and_clear():
    step = CompiledStep(torch.device("cpu"))
    assert not step.graphed
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2}

    for v in (1, 2, 3):
        out = step.run(("k",), fn, {"x": torch.full((2,), v)}).out
        assert out["y"].tolist() == [2 * v, 2 * v]
    step.run(("j",), fn, {"x": torch.zeros(3)})
    assert step.captures == 2 and step.replays == {("k",): 2, ("j",): 0}
    assert len(calls) == 4  # on the CPU, every step calls fn on the static buffers
    step.clear()
    assert len(step) == 0 and step.replays == {}


@pytest.fixture(scope="module")
def decoder():
    fam = jax_get_model("decoder_lm")
    jcfg = fam.make_config(**TINY)
    jparams = fam.init(jax.random.PRNGKey(3), jcfg)
    return jparams, jcfg, params_from_jax(jax.device_get(jparams)), \
        get_model("decoder_lm").make_config(**TINY)


def _serve(cls, params, cfg, prompts, warm=False, **kw):
    async def go():
        server = cls(params, cfg, slots=2, page_size=4, max_seq=40, **kw)
        if warm:
            server.warmup()
        free = len(server._free_pages)
        outs = await asyncio.gather(*[server.generate(p, max_new_tokens=6) for p in prompts])
        await server.close()
        assert len(server._free_pages) == free and not server._page_refs
        return outs, server

    return asyncio.run(go())


@pytest.mark.parametrize("kw", [{}, {"decode_kernel": "paged"}, {"dispatch_depth": 2},
                                {"prefill_chunk": 4}],
                         ids=["gather", "paged", "depth2", "chunked"])
def test_server_compiled_steps_equal_eager_and_jax(decoder, kw):
    """The server's step keys, captured at warmup: greedy streams equal to
    ``eager=True`` and to the JAX server on ``TP_PROMPTS`` (seed 3), with no
    page leaked; depth 2 equal to depth 1."""
    jparams, jcfg, params, cfg = decoder
    got, server = _serve(GenerationServer, params, cfg, TP_PROMPTS, warm=True, **kw)
    eager, eager_server = _serve(GenerationServer, params, cfg, TP_PROMPTS, eager=True, **kw)
    want, _ = _serve(JaxGenerationServer, jparams, jcfg, TP_PROMPTS)
    assert got == eager == want
    assert eager_server.warmup() == 0
    kernel = server.decode_kernel
    keys = {("decode", kernel), *(("prefill", b) for b in server._one_shot_buckets())}
    if kw.get("prefill_chunk"):
        keys.add(("chunk", 4, kernel))
    assert set(server._compiled.keys()) == keys and server.captures == len(keys)
    assert server.replay_counts()[("decode", kernel)] == server.decode_steps
    assert 0.0 < server.duty_cycle() <= 1.0 and server._duty.inflight == 0


def test_server_one_shot_buckets_follow_the_chunk(decoder):
    _, _, params, cfg = decoder
    chunked = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40,
                               prompt_buckets=[4, 8, 16], prefill_chunk=8)
    assert chunked.prompt_buckets == [4, 8, 16, 40]
    assert chunked._one_shot_buckets() == [4, 8]  # prompts over 8 tokens go in chunks
    whole = GenerationServer(params, cfg, slots=2, page_size=4, max_seq=40,
                             prompt_buckets=[4, 8, 16])
    assert whole._one_shot_buckets() == [4, 8, 16, 40]


def test_gpu_generate_connect_captures(decoder):
    proc = build_component("processor", {
        "type": "gpu_generate", "model": "decoder_lm", "model_config": {
            k: v for k, v in TINY.items() if k != "max_seq"},
        "serving": "continuous", "slots": 2, "page_size": 4, "max_input": 16,
        "max_new_tokens": 4, "seq_buckets": [8, 16], "prefill_chunk": 8,
        "device": "cpu"}, Resource())
    asyncio.run(proc.connect())
    assert set(proc.server._compiled.keys()) == {
        ("decode", "gather"), ("chunk", 8, "gather"), ("prefill", 8)}


#: calls that wait for the device or read a device value on the host: none
#: may sit on a captured step
HOST_SYNCS = ("item", "cpu", "tolist", "numpy", "nonzero", "synchronize")


@pytest.mark.parametrize("path", sorted((ROOT / "arkflow_tpu_torch" / "models").glob("*.py"))
                         + sorted((ROOT / "arkflow_tpu_torch" / "ops").glob("*.py")),
                         ids=lambda p: p.name)
def test_no_host_sync_on_the_captured_path(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = [f"{node.func.attr} at line {node.lineno}" for node in ast.walk(tree)
             if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
             and node.func.attr in HOST_SYNCS]
    assert not found, f"{path.name}: {found}"
