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
    int8 = ModelRunner("bert_classifier", TINY_BERT, buckets=BucketPolicy(BATCH, SEQ),
                       device="cpu", serving_dtype="int8")
    assert int8.params["layers"]["q"]["w_q"].dtype == torch.int8
    assert int8.infer_sync(_inputs(3, 3, 10, 10))["label"].shape == (3,)
    with pytest.raises(ConfigError, match="invalid"):
        ModelRunner("bert_classifier", TINY_BERT, device="cpu", serving_dtype="fp8")


def _packed_layout(seed: int, n: int, smax: int, seq: int):
    from arkflow_tpu_torch.tpu.packing import pack_tokens

    rng = np.random.RandomState(seed)
    lengths = np.where(rng.rand(n) < 0.8, rng.randint(2, 7, n),
                       rng.randint(smax // 2, smax + 1, n)).astype(np.int64)
    ids = np.zeros((n, smax), np.int32)
    for i, length in enumerate(lengths):
        ids[i, :length] = rng.randint(4, TINY_BERT["vocab_size"], length)
    mask = (np.arange(smax)[None, :] < lengths[:, None]).astype(np.int32)
    pk = pack_tokens(ids, lengths, seq)
    packed = {k: getattr(pk, k) for k in
              ("input_ids", "segment_ids", "position_ids", "example_row", "example_pos")}
    return {"input_ids": ids, "attention_mask": mask}, packed


@pytest.mark.parametrize("packed_flash", [False, True])
def test_packed_runner_matches_padded_and_jax_runners(packed_flash):
    """The packed runner's per-example outputs equal the padded runner's on
    the same texts, and the JAX packed runner's on the same layout; rows
    pad to a row bucket and examples to an example bucket."""
    host = _host_params(2)
    padded_in, packed_in = _packed_layout(6, 24, 24, 32)
    buckets = BucketPolicy(BATCH, SEQ, example_scale=4)
    packed = ModelRunner("bert_classifier", {**TINY_BERT, "packed_flash": packed_flash},
                         buckets=buckets, device="cpu", host_params=params_from_jax(host),
                         packed=True)
    assert packed.cfg.packed_flash is packed_flash
    got = packed.infer_sync(packed_in)
    assert got["label"].shape == (24,) and packed.packed_steps == packed.device_steps == 1
    assert packed.rows == 24
    rows = packed_in["input_ids"].shape[0]
    assert packed.true_tokens == int((packed_in["segment_ids"] > 0).sum())
    assert packed.token_capacity == packed.buckets.batch_bucket(rows) * 32
    want = _port_runner(False, host).infer_sync(padded_in)
    jax_packed = JaxModelRunner(
        "bert_classifier", {**TINY_BERT, "packed_flash": packed_flash,
                            "flash_interpret": packed_flash, "flash_min_seq": 1},
        buckets=JaxBucketPolicy(BATCH, SEQ, example_scale=4), host_params=host,
        packed=True).infer_sync(packed_in)
    for ref in (want, jax_packed):
        np.testing.assert_allclose(got["logits"], ref["logits"], atol=LOGIT_ATOL, rtol=0)
        top2 = np.sort(ref["logits"], axis=1)
        tie_free = (top2[:, -1] - top2[:, -2]) > TIE_MARGIN
        np.testing.assert_array_equal(got["label"][tie_free], ref["label"][tie_free])


def test_packed_grid_raises_rather_than_chunks():
    runner = ModelRunner("bert_classifier", TINY_BERT, buckets=BucketPolicy(BATCH, SEQ),
                         device="cpu", packed=True)
    _, packed_in = _packed_layout(7, 80, 32, 32)
    assert packed_in["input_ids"].shape[0] > BATCH[-1]
    with pytest.raises(ConfigError, match="carve"):
        runner.infer_sync(packed_in)
    too_many = {k: v[:2] if v.ndim == 2 else np.zeros(BATCH[-1] + 1, np.int32)
                for k, v in packed_in.items()}
    with pytest.raises(ConfigError, match="exceeds the grid"):
        runner.infer_sync(too_many)
    assert runner.device_steps == 0


def test_packed_warmup_steps_every_row_and_example_bucket_pair():
    runner = ModelRunner("bert_classifier", TINY_BERT,
                         buckets=BucketPolicy(BATCH, SEQ, example_scale=4), device="cpu",
                         packed=True)
    ebs = runner.buckets.example_buckets()
    assert ebs == (4, 8, 16, 32)
    pairs = sum(1 for eb in ebs for pb in BATCH if pb <= eb)
    assert runner.warmup() == pairs * len(SEQ)
    assert runner.packed_steps == pairs * len(SEQ) and runner.rows == 0
    assert runner.true_tokens == runner.token_capacity == 0  # warmup is not traffic


def test_packed_flash_follows_the_device_and_kill_switch(monkeypatch):
    from arkflow_tpu_torch.models import get_model

    fam = get_model("bert_classifier")
    resolve = ModelRunner._resolve_auto_flags
    unset = fam.make_config(**TINY_BERT)
    assert resolve(unset, torch.device("cuda"), True).packed_flash is True
    assert resolve(unset, torch.device("cpu"), True).packed_flash is False
    assert resolve(unset, torch.device("cuda")).packed_flash is None  # unpacked: untouched
    forced = fam.make_config(**TINY_BERT, packed_flash=True)
    assert resolve(forced, torch.device("cpu"), True).packed_flash is True
    monkeypatch.setenv("ARKFLOW_FLASH", "0")
    assert resolve(forced, torch.device("cuda"), True).packed_flash is False
    assert resolve(unset, torch.device("cuda"), True).packed_flash is False
