"""Port parity: the model building blocks of ``arkflow_tpu_torch.models.common``
against ``arkflow_tpu.models.common`` on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import common as jcm
from arkflow_tpu_torch.models import common as tcm

#: one bf16 ulp relative (2^-7): both sides round the same f32 value to
#: bf16, but sums taken in another order can land one ulp apart
BF16_RTOL = 2.0 ** -7
#: f32 results: summation order only
F32_ATOL = 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_dense_casts_and_adds_in_bf16():
    x, w, b = _rand(0, 4, 8, 32), _rand(1, 32, 24) * 0.2, _rand(2, 24)
    want = jcm.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = tcm.dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # the product and the bias add each round to bf16; 1/64 absolute covers
    # results that cancel to near zero, where the product's ulp dominates
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL, atol=1.0 / 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_in_f32_returns_input_dtype(dtype):
    x = _rand(3, 4, 8, 32) * 3 + 1
    p = {"scale": _rand(4, 32), "bias": _rand(5, 32)}
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jcm.layer_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, jdt))
    got = tcm.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)
    else:  # f32 statistics, one rounding to bf16 at the end
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL, atol=2.0 ** -9)


def test_embedding_casts_table_before_gather():
    table = _rand(6, 50, 16)
    ids = np.random.default_rng(7).integers(0, 50, (3, 9)).astype(np.int32)
    want = jcm.embedding({"table": jnp.asarray(table)}, jnp.asarray(ids))
    got = tcm.embedding({"table": torch.from_numpy(table)}, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))  # a gather: exact


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_tanh_approximation(dtype):
    x = _rand(8, 6, 64) * 3
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jcm.gelu(jnp.asarray(x, jdt))
    got = tcm.gelu(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)
    else:
        # XLA rounds each intermediate of the tanh formula to bf16, torch
        # rounds once at the end: small outputs drift by a few of the
        # intermediates' ulps, which stays inside the bf16 floor 1/64
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL, atol=1.0 / 64)


@pytest.mark.parametrize("softmax_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_rounds_scores_to_q_dtype_and_masks(dtype, softmax_dtype):
    b, s, h, d = 3, 12, 2, 8
    q, k, v = (_rand(10 + i, b, s, h, d) for i in range(3))
    lengths = np.array([12, 5, 1])
    mask = (np.arange(s)[None, :] < lengths[:, None])[:, None, None, :]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    sdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    want = jcm.attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(mask),
                         softmax_dtype=sdt[softmax_dtype][0])
    got = tcm.attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                        torch.from_numpy(mask), softmax_dtype=sdt[softmax_dtype][1])
    assert got.dtype == tdt
    if dtype == "float32" and softmax_dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)
    else:
        # scores, probabilities and output each round to bf16: a one-ulp
        # flip in a score moves its probability by ~2^-8, so the output
        # (a mix of values of size ~1) lands within the bf16 floor 1/64
        np.testing.assert_allclose(_np(got), _np(want), atol=1.0 / 64, rtol=0)
