"""Port parity: the ragged attention kernel's plain PyTorch version against
the JAX package's Pallas kernel in interpret mode, and the wrapper's CPU
routing. (The CUDA kernel itself runs only on the card: chip_smoke.py holds
it against this plain version there.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.ops.ragged_attention import ragged_flash_attention as jax_ragged
from arkflow_tpu_torch.ops import ragged_attention as ra

#: float32: the online softmax (JAX kernel) and the full softmax (plain
#: version) add in different orders, a few f32 ulps on outputs of size ~1
F32_ATOL = 1e-5
#: bfloat16 inputs: both compute in f32 and round the output to bf16 once, so
#: they can differ by one bf16 ulp; 1/64 is the bf16 floor the port uses
BF16_ATOL = 1.0 / 64


def _inputs(seed: int, b: int, h: int, s: int, d: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,tile", [(13, 13), (32, 8), (24, 8)])
def test_plain_matches_jax_kernel(s, tile, causal, dtype):
    """lengths {0, 1, mid, S}; S not a multiple of 8 included; pad queries
    exactly zero on both sides."""
    b, h, d = 4, 2, 8
    q, k, v = _inputs(s + 7 * causal, b, h, s, d)
    lengths = np.array([0, 1, s // 2, s], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jax_ragged(*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(lengths),
                      causal=causal, tile_q=tile, tile_k=tile, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = ra.ragged_attention_reference(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                        torch.from_numpy(lengths), causal=causal)
    assert got.dtype == tdt and got.shape == (b, h, s, d)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL if dtype == "float32" else BF16_ATOL,
                               rtol=0)
    for i, n in enumerate(lengths):
        assert (got[i, :, n:] == 0).all() and (want[i, :, n:] == 0).all()


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 2, 2, 16, 8))
    lengths = torch.tensor([16, 5], dtype=torch.int32)
    before = ra.launches.value
    out = ra.ragged_flash_attention(q, k, v, lengths)
    assert ra.launches.value == before
    torch.testing.assert_close(out, ra.ragged_attention_reference(q, k, v, lengths),
                               rtol=0, atol=0)


def test_wrapper_reads_strided_views_like_the_model_hands_them():
    """The model passes [B, S, H, D] projections as [B, H, S, D] views; the
    result must equal the one on contiguous copies."""
    x = [torch.from_numpy(a).transpose(1, 2) for a in _inputs(4, 2, 16, 2, 8)]  # [B,S,H,D] data
    lengths = torch.tensor([7, 16], dtype=torch.int32)
    got = ra.ragged_flash_attention(*x, lengths)
    want = ra.ragged_flash_attention(*(t.contiguous() for t in x), lengths)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ra.ragged_flash_attention(q, q, q, torch.zeros(1, dtype=torch.int32, device="meta"))
