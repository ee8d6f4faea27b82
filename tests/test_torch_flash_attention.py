"""K4, the port's dense flash attention (``arkflow_tpu_torch.ops.flash_attention``):
its plain version against the JAX package's Pallas kernel in interpret mode
at the shapes and tiles of ``tests/test_parallel_ops.py``, causal and not,
in f32 and bf16; the ragged-tile ``ValueError``; and the CPU wrapper taking
the plain version without counting a launch. The CUDA kernel is held against
the plain version on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from arkflow_tpu_torch.ops import flash_attention, flash_attention_reference
from arkflow_tpu_torch.ops import ragged_attention as ra

F32_ATOL = 2e-5  # the f32 floor of the parity rules
BF16_ATOL = 1.0 / 64  # the bf16 floor: one rounding of the output


def _qkv(seed: int, shape, scale: float):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) * scale for _ in range(3)]


def _jax(q, k, v, dtype=jnp.float32, **kw):
    return np.asarray(jax_flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                                          interpret=True, **kw).astype(jnp.float32))


@pytest.mark.parametrize("seed,shape,scale,causal,tile", [
    (0, (2, 3, 64, 16), 0.5, False, 16),  # test_flash_attention_matches_reference
    (1, (1, 2, 32, 8), 1.0, True, 8),     # test_flash_attention_causal
    (2, (2, 2, 64, 16), 1.0, True, 16),
    (3, (1, 2, 48, 8), 1.0, False, 128),  # tiles larger than S clamp to S
])
def test_plain_version_matches_the_pallas_kernel(seed, shape, scale, causal, tile):
    q, k, v = _qkv(seed, shape, scale)
    want = _jax(q, k, v, causal=causal, tile_q=tile, tile_k=tile)
    got = flash_attention_reference(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                    tile_k=min(tile, shape[2]))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_the_pallas_kernel(causal):
    """bf16 operands: both work in f32 inside and round the output once."""
    q, k, v = (x.astype(jnp.bfloat16).astype(np.float32) for x in _qkv(4, (2, 2, 32, 16), 1.0))
    want = _jax(q, k, v, dtype=jnp.bfloat16, causal=causal, tile_q=8, tile_k=8)
    got = flash_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                          causal=causal, tile_q=8, tile_k=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL, rtol=0)


def test_rejects_ragged_tiles():
    q = torch.zeros(1, 1, 30, 8)
    with pytest.raises(ValueError, match="must divide tiles"):
        flash_attention(q, q, q, tile_q=16, tile_k=16)
    with pytest.raises(ValueError):
        jax_flash_attention(jnp.zeros((1, 1, 30, 8)), jnp.zeros((1, 1, 30, 8)),
                            jnp.zeros((1, 1, 30, 8)), tile_q=16, tile_k=16, interpret=True)


def test_cpu_wrapper_takes_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, (1, 2, 32, 8), 1.0))
    flash_attention.launches.reset()
    k1_before = ra.launches.value
    got = flash_attention(q, k, v, causal=True, tile_q=16, tile_k=16)
    assert torch.equal(got, flash_attention_reference(q, k, v, causal=True, tile_k=16))
    assert flash_attention.launches.value == 0 and ra.launches.value == k1_before
    # [B, S, H, D] storage viewed as [B, H, S, D], the layout the models hand over
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    torch.testing.assert_close(flash_attention(qt, kt, vt, causal=True), got, atol=1e-6, rtol=0)
