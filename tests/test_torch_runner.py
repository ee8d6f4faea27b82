"""Port parity: ``arkflow_tpu_torch.tpu.runner.ModelRunner(device="cpu")``
against the JAX ``ModelRunner`` on the same host params, over padding rows,
chunking above the top batch bucket and several seq buckets; plus the
runner's device rule, right-padding guard and auto fallback."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.tpu.bucketing import BucketPolicy as JaxBucketPolicy
from arkflow_tpu.tpu.runner import ModelRunner as JaxModelRunner
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy
from arkflow_tpu_torch.tpu.runner import ModelRunner
from tests.test_tpu_layer import TINY_BERT

#: logits of the bf16 model: the bf16 floor of the parity rules
LOGIT_ATOL = 1.0 / 64
TIE_MARGIN = 0.05
BATCH, SEQ = (4, 8), (16, 32)


def _host_params(seed: int = 0):
    fam = jax_get_model("bert_classifier")
    return jax.device_get(fam.init(jax.random.PRNGKey(seed), fam.make_config(**TINY_BERT)))


def _inputs(seed: int, rows: int, width: int, max_len: int):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, max_len + 1, rows)
    mask = (np.arange(width)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(4, TINY_BERT["vocab_size"], (rows, width)).astype(np.int32) * mask
    return {"input_ids": ids, "attention_mask": mask}


def _port_runner(flash, host, **kw):
    return ModelRunner("bert_classifier", {**TINY_BERT, "use_flash_attention": flash},
                       buckets=BucketPolicy(BATCH, SEQ), device="cpu",
                       host_params=params_from_jax(host), **kw)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("rows,width,max_len", [(3, 10, 10), (19, 30, 30), (9, 40, 40)])
def test_infer_sync_matches_jax_runner(flash, rows, width, max_len):
    """3 rows pad to the 4-row bucket; 19 rows chunk into 8+8+3 above the
    top bucket; widths land on the 16/32 seq buckets, and 40 truncates to
    the top bucket."""
    host = _host_params()
    jax_runner = JaxModelRunner(
        "bert_classifier", {**TINY_BERT, "use_flash_attention": flash, "flash_interpret": flash},
        buckets=JaxBucketPolicy(BATCH, SEQ), host_params=host)
    runner = _port_runner(flash, host)
    inputs = _inputs(rows + width, rows, width, max_len)
    want = jax_runner.infer_sync(inputs)
    got = runner.infer_sync(inputs)
    assert set(got) == set(want)
    assert got["label"].shape == (rows,) and got["logits"].shape == (rows, 2)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want["logits"], axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > TIE_MARGIN
    np.testing.assert_array_equal(got["label"][tie_free], want["label"][tie_free])
    assert runner.rows == rows
    assert runner.device_steps == -(-rows // BATCH[-1])
    assert runner.flash_fallbacks == 0


def test_async_infer_equals_infer_sync():
    runner = _port_runner(True, _host_params(1))
    inputs = _inputs(5, 13, 20, 20)
    want = runner.infer_sync(inputs)

    async def go():
        return await asyncio.gather(runner.infer(inputs), runner.infer(inputs))

    for got in asyncio.run(go()):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def _left_padded():
    mask = np.ones((2, 16), np.int32)
    mask[:, 0] = 0  # left padding: not a contiguous prefix of ones
    return {"input_ids": np.ones((2, 16), np.int32), "attention_mask": mask}


def test_right_padding_guard_raises_when_flash_forced():
    runner = _port_runner(True, _host_params())
    with pytest.raises(ConfigError, match="right-padded"):
        runner.infer_sync(_left_padded())
    assert runner.cfg.use_flash_attention is True
    assert runner.flash_fallbacks == 0


def test_auto_flash_falls_back_and_counts():
    host = _host_params()
    runner = _port_runner(True, host)
    runner._flash_user_forced = False  # simulate auto-resolution (CPU resolves False)
    out = runner.infer_sync(_left_padded())
    assert out["label"].shape == (2,)
    assert runner.cfg.use_flash_attention is False and runner.flash_fallbacks == 1
    runner.infer_sync(_left_padded())  # stays on the plain path, counted once
    assert runner.flash_fallbacks == 1
    want = JaxModelRunner("bert_classifier", TINY_BERT, buckets=JaxBucketPolicy(BATCH, SEQ),
                          host_params=host).infer_sync(_left_padded())
    np.testing.assert_allclose(out["logits"], want["logits"], atol=LOGIT_ATOL, rtol=0)


def test_flash_floor_skips_the_guard_below_it():
    runner = ModelRunner("bert_classifier", {**TINY_BERT, "use_flash_attention": True,
                                             "flash_min_seq": 32},
                         buckets=BucketPolicy(BATCH, SEQ), device="cpu")
    assert runner.infer_sync(_left_padded())["label"].shape == (2,)
    assert runner.cfg.use_flash_attention is True and runner.flash_fallbacks == 0


def test_device_rule(monkeypatch):
    """No device means CUDA, and without a card that raises; the CPU must
    be asked for. Auto flash resolves off on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        ModelRunner("bert_classifier", TINY_BERT)
    with pytest.raises(ConfigError, match="no CUDA device"):
        ModelRunner("bert_classifier", TINY_BERT, device="cuda")
    cpu = ModelRunner("bert_classifier", TINY_BERT, device="cpu")
    assert cpu.device.type == "cpu" and cpu.cfg.use_flash_attention is False
    assert all(t.device.type == "cpu" for t in cpu.params["layers"]["q"].values())


def test_auto_flags_follow_the_device_and_kill_switch(monkeypatch):
    from arkflow_tpu_torch.models import get_model

    cfg = get_model("bert_classifier").make_config(**TINY_BERT)
    resolve = ModelRunner._resolve_auto_flags
    on_cuda = resolve(cfg, torch.device("cuda"))
    assert on_cuda.use_flash_attention is True and on_cuda.flash_min_seq == 0
    assert resolve(cfg, torch.device("cpu")).use_flash_attention is False
    monkeypatch.setenv("ARKFLOW_FLASH", "0")
    forced = get_model("bert_classifier").make_config(**TINY_BERT, use_flash_attention=True)
    assert resolve(forced, torch.device("cuda")).use_flash_attention is False


def test_serving_dtype_and_warmup():
    runner = ModelRunner("bert_classifier", TINY_BERT, buckets=BucketPolicy(BATCH, SEQ),
                         device="cpu", serving_dtype="bfloat16")
    assert runner.params["layers"]["q"]["w"].dtype == torch.bfloat16
    assert runner.warmup() == len(BATCH) * len(SEQ)
    assert runner.device_steps == len(BATCH) * len(SEQ) and runner.rows == 0
    with pytest.raises(ConfigError, match="not yet ported"):
        ModelRunner("bert_classifier", TINY_BERT, device="cpu", serving_dtype="int8")
