"""The port's paged KV-cache steps against the JAX package's on the same
weights (JAX-initialised, ``params_from_jax``), the same numpy inputs and
the same starting pools, at the JAX suites' TINY shape: ``paged_prefill``,
``paged_prefill_chunk`` and ``paged_decode_step``, each with the gather
path and with the paged kernel (Pallas in interpret mode on the JAX side,
K3's plain version here). Logits agree at the bf16 floor; the pools agree
exactly where the first layer wrote (its K/V come straight from the
embedding) and at the bf16 floor in later layers, whose inputs went
through bf16 matmuls summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.models import paged_decode as jpd
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.models import paged_decode as pd

TINY = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, ffn=96, max_seq=64)
LOGIT_ATOL = 1.0 / 64
PAGE, NUM_PAGES = 4, 11
# non-contiguous tables; row 2 is an idle lane that owns no page
TABLE = np.asarray([[5, 2, 7, 9, 0, 0, 0, 0], [1, 3, 4, 6, 8, 0, 0, 0], [0] * 8], np.int32)


@pytest.fixture(scope="module")
def tiny():
    fam = jax_get_model("decoder_lm")
    jcfg = fam.make_config(**TINY)
    jparams = fam.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams))
    return jparams, jcfg, params, get_model("decoder_lm").make_config(**TINY)


def _pools(seed: int):
    """The same random starting pools for both packages (bf16 values)."""
    rng = np.random.RandomState(seed)
    shape = (TINY["layers"], NUM_PAGES, PAGE, TINY["kv_heads"], TINY["dim"] // TINY["heads"])
    k, v = (jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.5, jnp.bfloat16)
            for _ in range(2))
    as_torch = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
    return (k, v), (as_torch(k), as_torch(v))


def _check_pools(jpools, tpools, rows_written):
    """Pages past the scratch page agree: exactly in layer 0, at the bf16
    floor elsewhere; pages no row wrote keep their starting contents."""
    for jp, tp in zip(jpools, tpools):
        want = np.asarray(jp.astype(jnp.float32))[:, 1:]
        got = tp.float().numpy()[:, 1:]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    untouched = sorted(set(range(1, NUM_PAGES)) - set(TABLE[rows_written].ravel().tolist()))
    for jp, tp in zip(jpools, tpools):
        np.testing.assert_array_equal(tp.float().numpy()[:, untouched],
                                      np.asarray(jp.astype(jnp.float32))[:, untouched])


def test_paged_prefill_matches_jax(tiny):
    jparams, jcfg, params, cfg = tiny
    ids = np.asarray([[3, 17, 42, 7, 91, 0, 0, 0], [5, 9, 1, 2, 3, 4, 5, 6], [0] * 8], np.int32)
    lens = np.asarray([5, 8, 0], np.int32)
    (jk, jv), (tk, tv) = _pools(0)
    jl, jk, jv = jpd.paged_prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens),
                                   jnp.asarray(TABLE), jk, jv, return_logits=True)
    tl, tk2, tv2 = pd.paged_prefill(params, cfg, torch.from_numpy(ids), torch.from_numpy(lens),
                                    torch.from_numpy(TABLE), tk, tv, return_logits=True)
    assert tk2 is tk and tv2 is tv  # written in place, returned as the JAX code returns them
    assert tl.dtype == torch.float32 and tl.shape == (3, TINY["vocab_size"])
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=LOGIT_ATOL, rtol=0)
    _check_pools((jk, jv), (tk, tv), [0, 1])
    nxt, *_ = pd.paged_prefill(params, cfg, torch.from_numpy(ids), torch.from_numpy(lens),
                               torch.from_numpy(TABLE), tk.clone(), tv.clone())
    assert nxt.dtype == torch.int32 and nxt.tolist()[:2] == tl.argmax(-1).tolist()[:2]


@pytest.mark.parametrize("kernel", ["gather", "paged"])
def test_paged_decode_step_matches_jax(tiny, kernel):
    jparams, jcfg, params, cfg = tiny
    tok = np.asarray([3, 9, 0], np.int32)
    lens = np.asarray([5, 8, 0], np.int32)  # row 1 writes the first slot of its third page
    act = np.asarray([True, True, False])
    (jk, jv), (tk, tv) = _pools(1)
    jl, jk, jv = jpd.paged_decode_step(
        jparams, jcfg, jnp.asarray(tok), jnp.asarray(lens), jnp.asarray(act),
        jnp.asarray(TABLE), jk, jv, return_logits=True, attention_kernel=kernel,
        kernel_interpret=True)
    tl, *_ = pd.paged_decode_step(
        params, cfg, torch.from_numpy(tok), torch.from_numpy(lens), torch.from_numpy(act),
        torch.from_numpy(TABLE), tk, tv, return_logits=True, attention_kernel=kernel)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=LOGIT_ATOL, rtol=0)
    _check_pools((jk, jv), (tk, tv), [0, 1])


@pytest.mark.parametrize("kernel,return_all", [("gather", True), ("paged", True),
                                               ("paged", False)])
def test_paged_prefill_chunk_matches_jax(tiny, kernel, return_all):
    jparams, jcfg, params, cfg = tiny
    ids = np.asarray([[7, 8, 3], [1, 2, 0], [0, 0, 0]], np.int32)
    off = np.asarray([5, 6, 0], np.int32)  # mid-page offsets over earlier context
    clen = np.asarray([3, 2, 0], np.int32)
    (jk, jv), (tk, tv) = _pools(2)
    jl, jk, jv = jpd.paged_prefill_chunk(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(off), jnp.asarray(clen),
        jnp.asarray(TABLE), jk, jv, return_all=return_all, attention_kernel=kernel,
        kernel_interpret=True)
    tl, *_ = pd.paged_prefill_chunk(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(off), torch.from_numpy(clen),
        torch.from_numpy(TABLE), tk, tv, return_all=return_all, attention_kernel=kernel)
    assert tl.shape == np.asarray(jl).shape
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=LOGIT_ATOL, rtol=0)
    _check_pools((jk, jv), (tk, tv), [0, 1])


def test_init_page_pool_is_bf16_zeros_in_the_jax_shape(tiny):
    _, jcfg, _, cfg = tiny
    k, v = pd.init_page_pool(cfg, 7, 4)
    jk, _ = jpd.init_page_pool(jcfg, 7, 4)
    assert k.shape == v.shape == jk.shape and k.dtype == torch.bfloat16
    assert not k.any() and k.data_ptr() != v.data_ptr()


def test_unported_and_invalid_options_raise(tiny):
    _, _, params, cfg = tiny
    k, v = pd.init_page_pool(cfg, 3, 4)
    args = (torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.bool), torch.ones(1, 1, dtype=torch.int32), k, v)
    with pytest.raises(ConfigError, match="not yet ported"):
        pd.paged_decode_step(params, cfg, *args, kv_sharding="tp")
    with pytest.raises(ValueError, match="gather|paged"):
        pd.paged_decode_step(params, cfg, *args, attention_kernel="dense")
