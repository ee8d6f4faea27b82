"""The port's hot swap (``tpu/swap.py``) on the CPU: ``parse_swap_config``
and the numpy helpers against the JAX package's, and swaps on the padded,
packed and int8 runners of ``gpu_inference``: identical weights keep the
outputs; other weights (the JAX package's init, seed 1) give a fresh port
runner's logits bit for bit and the JAX runner's within the parity floor,
with the live tensors' addresses and the captures unchanged; a corrupt
checkpoint and a crash mid-flip roll back to the old outputs bit for bit;
a second swap while one runs is rejected.

The swaps that must be rolled back by the canary use 16 golden rows: with
two labels, 4 rows leave a mangled tree a fair chance of agreeing on all of
them."""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.tpu import swap as jax_swap
from arkflow_tpu.tpu.bucketing import BucketPolicy as JaxBucketPolicy
from arkflow_tpu.tpu.runner import ModelRunner as JaxModelRunner
from arkflow_tpu.tpu.runner import convert_for_serving as jax_convert_for_serving
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, ensure_plugins_loaded
from arkflow_tpu_torch.components.registry import build_component
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError, SwapError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.tpu import checkpoint
from arkflow_tpu_torch.tpu import swap as port_swap
from arkflow_tpu_torch.tpu.bucketing import bucket_cap_bus
from arkflow_tpu_torch.tpu.integrity import flatten
from arkflow_tpu_torch.tpu.runner import ModelRunner, init_host_params
from arkflow_tpu_torch.tpu.swap import (ModelSwapManager, SwapConfig, argmax_signature,
                                        golden_inputs, parse_swap_config, signature_margin)
from tests.test_torch_runner import _packed_layout
from tests.test_tpu_layer import TINY_BERT

ensure_plugins_loaded()

MODES = ["padded", "packed", "int8"]
#: swapped-in weights against the JAX runner on the same weights: 1/64 in
#: every mode (at int8 the jitted JAX runner's fused bf16 rounding moves a
#: quantized code now and then; at TINY_BERT, seed 1, it lies 0.0117 away)
LOGIT_ATOL = 1.0 / 64
TIE_MARGIN = 0.05
TEXTS = [b"alpha beta", b"a much longer text with many more words in it", b"x",
         b"sensor reading seven", b"pressure spike on line four", b"gamma"]


@pytest.fixture(autouse=True)
def _reset_cap_bus():
    yield
    bucket_cap_bus().reset()


@pytest.fixture(scope="module")
def seed1_jax():
    fam = jax_get_model("bert_classifier")
    return jax.device_get(fam.init(jax.random.PRNGKey(1), fam.make_config(**TINY_BERT)))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, seed1_jax):
    """The port's seed-0 init tree (what the processors boot with) and the
    JAX package's seed-1 init tree, as port checkpoints."""
    d = tmp_path_factory.mktemp("ck")
    fam = get_model("bert_classifier")
    checkpoint.save(str(d / "seed0"), init_host_params(fam, fam.make_config(**TINY_BERT), 0))
    checkpoint.save(str(d / "seed1"), params_from_jax(seed1_jax))
    checkpoint.save(str(d / "other"), {"w": torch.ones(3)})
    return d


def _proc_config(mode: str, **extra) -> dict:
    cfg = {"type": "gpu_inference", "model": "bert_classifier", "model_config": TINY_BERT,
           "device": "cpu", "max_seq": 16, "batch_buckets": [2, 4], "seq_buckets": [16],
           "warmup": True, "outputs": ["label", "score"]}
    if mode == "packed":
        cfg["packing"] = True
    if mode == "int8":
        cfg["serving_dtype"] = "int8"
    cfg.update(extra)
    return cfg


def _proc(mode: str, **extra):
    proc = build_component("processor", _proc_config(mode, **extra), Resource())
    proc.runner.warmup()
    proc._warmed = True
    return proc


def _runner_inputs(mode: str) -> dict:
    texts, packed = _packed_layout(4, 6, 16, 16)
    return packed if mode == "packed" else texts


def _ptrs(runner) -> list[int]:
    return [t.data_ptr() for t in flatten(runner.params).values()]


def _outputs(proc, batch) -> dict:
    out = asyncio.run(proc.process(batch))[0]
    return {k: np.asarray(out.column(k)) for k in ("label", "score")}


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# -- config and helpers against the JAX package ------------------------------


@pytest.mark.parametrize("cfg", [
    None, {"canary": {"rows": 8, "min_agreement": 0.5, "seed": 3}}, {"drain_timeout": "5s"},
    {"canary": {"rows": 0}}, [1], {"bogus": 1}, {"canary": [1]}, {"canary": {"rows": -1}},
    {"canary": {"rows": True}}, {"canary": {"min_agreement": 1.5}},
    {"canary": {"min_agreement": "1"}}, {"canary": {"seed": 1.5}}, {"canary": {"extra": 1}},
    {"drain_timeout": "0s"},
])
def test_parse_swap_config_matches_jax(cfg):
    try:
        want = jax_swap.parse_swap_config(cfg, who="gpu_inference")
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            parse_swap_config(cfg, who="gpu_inference")
        assert str(got.value) == str(e)
        return
    got = parse_swap_config(cfg, who="gpu_inference")
    assert (got.canary_rows, got.min_agreement, got.canary_seed, got.drain_timeout_s) == (
        want.canary_rows, want.min_agreement, want.canary_seed, want.drain_timeout_s)


@pytest.mark.parametrize("rows,seed,seq", [(4, 0x5117, 16), (2, 7, 8), (16, 0xB0B, 32)])
def test_golden_inputs_bitwise_equal_jax(rows, seed, seq):
    fam, jfam = get_model("bert_classifier"), jax_get_model("bert_classifier")
    cfg, jcfg = fam.make_config(**TINY_BERT), jfam.make_config(**TINY_BERT)
    got = golden_inputs(fam.input_spec(cfg), cfg, rows, seed, seq=seq)
    want = jax_swap.golden_inputs(jfam.input_spec(jcfg), jcfg, rows, seed, seq=seq)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    spec = {"x": (np.float32, (3,)), "ids": (np.int32, ("seq",))}
    got, want = (mod.golden_inputs(spec, cfg, rows, seed, seq=seq)
                 for mod in (port_swap, jax_swap))
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("outputs", [
    {"logits": np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)},
    {"label": np.array([1, 0]), "emb": np.random.default_rng(1).standard_normal((2, 4))},
    {"label": np.array([3, 1, 2])},
    {"logits": np.ones((4, 1), np.float32)},
    {"logits": np.array([[0.5, 0.5, 0.25], [2.0, -1.0, 2.0]], np.float32)},
])
def test_signature_helpers_bitwise_equal_jax(outputs):
    np.testing.assert_array_equal(argmax_signature(outputs),
                                  jax_swap.argmax_signature(outputs))
    assert signature_margin(outputs) == jax_swap.signature_margin(outputs)


# -- swaps on the runners -------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_swap_to_identical_weights_keeps_outputs(checkpoints, mode, monkeypatch):
    """The outputs and addresses stay; ``prepare`` restores into the
    runner's layout tree and runs no init of the family."""
    proc = _proc(mode)
    batch = MessageBatch.new_binary(TEXTS)
    before, ptrs = _outputs(proc, batch), _ptrs(proc.runner)

    def no_init(*a, **kw):
        raise AssertionError("a swap ran the family's init")

    monkeypatch.setattr(proc.runner.family, "init", no_init)
    rep = asyncio.run(proc.swapper.swap(str(checkpoints / "seed0")))
    assert rep["version"] == 1 and rep["completed"] == 1 and rep["state"] == "idle"
    assert set(rep["stage_ms"]) == {"prepare", "canary", "flip", "probe"}
    _equal(_outputs(proc, batch), before)
    assert _ptrs(proc.runner) == ptrs


@pytest.mark.parametrize("mode", MODES)
def test_swap_to_new_weights_matches_fresh_runner_and_jax(checkpoints, seed1_jax, mode):
    proc = _proc(mode, swap={"canary": {"min_agreement": 0.0}})
    runner = proc.runner
    inputs = _runner_inputs(mode)
    before = runner.infer_sync(inputs)
    ptrs, captures = _ptrs(runner), runner.captures
    asyncio.run(proc.swapper.swap(str(checkpoints / "seed1")))
    got = runner.infer_sync(inputs)
    assert _ptrs(runner) == ptrs and runner.captures == captures
    assert not np.array_equal(got["logits"], before["logits"])
    fresh = ModelRunner("bert_classifier", TINY_BERT, buckets=runner.buckets, device="cpu",
                        serving_dtype=runner.serving_dtype, packed=runner.packed,
                        host_params=params_from_jax(seed1_jax))
    want = fresh.infer_sync(inputs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jr = JaxModelRunner("bert_classifier", TINY_BERT,
                        buckets=JaxBucketPolicy((2, 4), (16,), example_scale=4 if mode == "packed"
                                                else 1),
                        host_params=jax_convert_for_serving(seed1_jax, runner.serving_dtype),
                        serving_dtype=runner.serving_dtype, packed=runner.packed)
    ref = jr.infer_sync(inputs)
    np.testing.assert_allclose(got["logits"], ref["logits"], atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(ref["logits"], axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > TIE_MARGIN
    np.testing.assert_array_equal(got["label"][tie_free], ref["label"][tie_free])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fault", ["truncated", "swap_corrupt", "swap_crash"])
def test_failed_swap_rolls_back_bit_for_bit(checkpoints, tmp_path, mode, fault):
    proc = _proc(mode, swap={"canary": {"rows": 16}})
    batch = MessageBatch.new_binary(TEXTS)
    before, ptrs, captures = _outputs(proc, batch), _ptrs(proc.runner), proc.runner.captures
    target = str(checkpoints / "seed1")
    if fault == "truncated":
        bad = tmp_path / "bad"
        checkpoint.save(str(bad), params_from_jax(jax.device_get(jax_get_model(
            "bert_classifier").init(jax.random.PRNGKey(2),
                                    jax_get_model("bert_classifier").make_config(**TINY_BERT)))))
        with open(bad / checkpoint.PARAMS_FILE, "r+b") as f:
            f.truncate(100)
        target = str(bad)
    else:
        proc.swapper.inject_swap_fault(fault)
    if fault == "swap_corrupt":
        # the mangled candidate of the booted weights: the canary rejects it
        target = str(checkpoints / "seed0")
    if fault == "swap_crash":
        proc.swapper.cfg = SwapConfig(canary_rows=0)
    with pytest.raises(SwapError, match="rolled back") as ei:
        asyncio.run(proc.swapper.swap(target))
    stage = {"truncated": "restore", "swap_corrupt": "canary", "swap_crash": "rolling flip"}
    assert f"at {stage[fault]}" in str(ei.value)
    rep = proc.swapper.report()
    assert rep["version"] == 0 and rep["rolled_back"] == 1 and rep["state"] == "idle"
    _equal(_outputs(proc, batch), before)
    assert _ptrs(proc.runner) == ptrs and proc.runner.captures == captures
    assert proc.runner.health.state == "healthy"


def test_swap_of_a_foreign_tree_names_the_leaves(checkpoints):
    proc = _proc("padded")
    with pytest.raises(SwapError, match=r"restore: failed to restore .*\['w'\]"):
        asyncio.run(proc.swapper.swap(str(checkpoints / "other")))


def test_swap_already_in_progress_rejected():
    class _Unit:
        label = "u"

        def __init__(self):
            self.params = {"w": torch.zeros(2)}

        def live(self):
            return self.params

        def place(self, host):
            return host

        async def adopt(self, placed):
            old, self.params = self.params, placed
            return old

        def note_committed_host(self, host):
            pass

        async def probe(self):
            return None

    def slow_prepare(path):
        time.sleep(0.3)
        return {"w": torch.ones(2)}

    mgr = ModelSwapManager(name="dummy", config=SwapConfig(canary_rows=0),
                           prepare=slow_prepare, canary=lambda p: np.zeros(1), units=[_Unit()])

    async def go():
        started = asyncio.Event()

        async def first():
            started.set()
            return await mgr.swap("/a")

        t = asyncio.create_task(first())
        await started.wait()
        await asyncio.sleep(0.05)
        with pytest.raises(SwapError, match="in progress"):
            await mgr.swap("/b")
        return await t

    assert asyncio.run(asyncio.wait_for(go(), 10))["version"] == 1
